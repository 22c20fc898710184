"""Parity of the port's LM cost model (``launch/costmodel.py``:
``analytic_cost``, ``T_enc_dec_kv`` and their helpers) and of its H100
hardware table and mesh shapes (``launch/mesh.py``) with the JAX
package's.

The same configs go through both packages (each package's own registry,
the FULL configs field for field the same): every dry-run cell, both
production meshes, each layout's data- and tensor-parallel degrees as
``dryrun.run_cell`` derives them, ``causal_skip`` and ``zero1`` both
ways.  The formulas keep the JAX package's arithmetic order, so the
results are held to a relative difference of 1e-12 (they are equal).
"""
import dataclasses

import pytest

jax = pytest.importorskip("jax")   # the reference package needs JAX

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.launch import costmodel as JC  # noqa: E402
from repro_torch.configs import (SHAPES, dryrun_cells, get_config,  # noqa: E402
                                 get_smoke_config, list_archs)
from repro_torch.launch import costmodel as TC  # noqa: E402
from repro_torch.launch.dryrun import mesh_dp_tp  # noqa: E402
from repro_torch.launch.mesh import HW, MESHES, Mesh, make_mesh  # noqa: E402

REL = 1e-12
CELLS = dryrun_cells()
LAYOUTS = ("tp", "fsdp", "zero1")


def close(a, b) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def assert_cost_equal(got, want, what):
    assert close(got.flops, want.flops), (what, got.flops, want.flops)
    assert close(got.hbm_bytes, want.hbm_bytes), (what, got.hbm_bytes,
                                                  want.hbm_bytes)
    assert close(got.coll_bytes, want.coll_bytes), (what, got.coll_bytes,
                                                    want.coll_bytes)
    assert set(got.detail) == set(want.detail), what
    for k in want.detail:
        assert close(got.detail[k], want.detail[k]), (what, k)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_analytic_cost_equals_reference(arch, shape):
    """Every cell x both meshes x three layouts x causal_skip x zero1."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for mesh_name in MESHES:
        mesh = make_mesh(mesh_name)
        for layout in LAYOUTS:
            dp, tp = mesh_dp_tp(mesh.shape, layout)
            for causal_skip in (False, True):
                for zero1 in (False, True):
                    kw = dict(dp=dp, tp=tp, causal_skip=causal_skip,
                              zero1=zero1)
                    got = TC.analytic_cost(cfg, SHAPES[shape], mesh.size,
                                           **kw)
                    want = JC.analytic_cost(jcfg, JSHAPES[shape], mesh.size,
                                            **kw)
                    assert_cost_equal(got, want, (mesh_name, layout, kw))


def test_dp_tp_follow_the_layout():
    """``run_cell``'s derivation: TP keeps (pod x data, model); fsdp and
    zero1 make the model axis data parallelism."""
    single, multi = MESHES["single"], MESHES["multi"]
    assert mesh_dp_tp(single, "tp") == (16, 16)
    assert mesh_dp_tp(multi, "tp") == (32, 16)
    assert mesh_dp_tp(single, "fsdp") == (256, 1)
    assert mesh_dp_tp(multi, "zero1") == (512, 1)


@pytest.mark.parametrize("arch", list_archs())
def test_helpers_equal_reference(arch):
    """``T_enc_dec_kv``, ``_layer_param_counts``, ``_pattern_counts``,
    ``_total_params``, ``_recurrent_state_bytes``, ``_act_bytes`` and
    ``_cache_bytes`` on the FULL and SMOKE configs."""
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_get_smoke(arch))):
        for B, S in ((1, 1), (128, 32768), (1, 524288), (3, 1500)):
            assert TC.T_enc_dec_kv(cfg, B, S) == JC.T_enc_dec_kv(jcfg, B, S)
            assert TC._cache_bytes(cfg, B, S) == JC._cache_bytes(jcfg, B, S)
            for train in (False, True):
                assert TC._recurrent_state_bytes(cfg, B / 16, S,
                                                 train=train) == \
                    JC._recurrent_state_bytes(jcfg, B / 16, S, train=train)
        assert TC._layer_param_counts(cfg) == JC._layer_param_counts(jcfg)
        for layers in (1, cfg.period, cfg.n_layers):
            assert TC._pattern_counts(cfg, layers) == \
                JC._pattern_counts(jcfg, layers)
        assert TC._total_params(cfg) == JC._total_params(jcfg)
        for dp, tp in ((16, 16), (256, 1), (1, 1)):
            for train in (False, True):
                assert TC._act_bytes(cfg, 4096.0 * 256, dp, tp,
                                     train=train) == \
                    JC._act_bytes(jcfg, 4096.0 * 256, dp, tp, train=train)


@pytest.mark.parametrize("impl", ["materialized", "chunked", "kernel"])
def test_scan_impl_names(impl):
    """The port's B6 scan is ``scan_impl="kernel"``, the JAX package's
    ``"pallas"``: both stream only the scan's inputs, and the other two
    forms are named alike."""
    jimpl = "pallas" if impl == "kernel" else impl
    cfg = get_config("jamba_1_5_large_398b")
    jcfg = jax_get_config("jamba_1_5_large_398b")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           scan_impl=impl))
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(
        jcfg.ssm, scan_impl=jimpl))
    for shape in ("train_4k", "prefill_32k"):
        got = TC.analytic_cost(cfg, SHAPES[shape], 256, dp=16, tp=16)
        want = JC.analytic_cost(jcfg, JSHAPES[shape], 256, dp=16, tp=16)
        assert_cost_equal(got, want, (impl, shape))
    if impl == "kernel":
        base = TC.analytic_cost(get_config("jamba_1_5_large_398b"),
                                SHAPES["train_4k"], 256, dp=16, tp=16)
        assert got.hbm_bytes < base.hbm_bytes      # no (B, S, di, N) terms


def test_hw_is_the_h100():
    """The JAX package's keys, with one H100 SXM5's values: dense bf16
    peak, the bandwidth chip_smoke.py measured (the devicepool entry),
    NVLink 4, 80 GB."""
    from repro.launch.mesh import HW as JHW
    from repro_torch.runtime.devicepool import KNOWN_DEVICE_SPECS
    assert set(HW) == set(JHW)
    assert HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3032.3e9,
                  "ici_bw": 900e9, "hbm_bytes": 80e9}
    assert HW["hbm_bw"] == KNOWN_DEVICE_SPECS["h100"]["mem_bw"]


def test_meshes_are_the_production_shapes():
    """The JAX package's production meshes: (16, 16) over (data, model)
    and (2, 16, 16) over (pod, data, model)."""
    single, multi = make_mesh("single"), make_mesh("multi")
    assert (single.axis_names, tuple(single.shape.values()), single.size) \
        == (("data", "model"), (16, 16), 256)
    assert (multi.axis_names, tuple(multi.shape.values()), multi.size) \
        == (("pod", "data", "model"), (2, 16, 16), 512)
    assert Mesh({"data": 2}).shape == {"data": 2}

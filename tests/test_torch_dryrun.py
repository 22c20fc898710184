"""The port's dry run (``launch/dryrun.py``), its hill-climb entry point
(``launch/hillclimb.py``), ``refresh_costs`` and ``roofline``, against the
JAX package where it has a counterpart.

* Configs: ``dryrun_cells()`` is the JAX list (32 cells, in order);
  ``input_specs`` gives the JAX shapes and dtypes.
* Structure: the structural sweep (``main(["--all", "--mesh",
  "single"])``, run once a module, into a temporary directory) gives
  every cell the JAX package's parameter counts and model FLOPs, the JAX
  cost model's terms with ``causal_skip=True``, and per-device argument
  bytes equal, as integers, to those of the JAX specs over the JAX trees
  (parameters, optimizer state, batch, cache); a dense and an MoE model
  under every layout and both meshes too.
* Round trip: ``refresh_costs`` rewrites the sweep's JSONs unchanged, and
  ``roofline`` renders its 32 rows.
* The measured pass: without a card it raises; its step functions run on
  the CPU at SMOKE widths (control flow only: its numbers come from the
  card); the ``gpu`` test measures one cell on the card.

The JAX package is imported inside fixtures, so the ``gpu`` test runs on
the card, where JAX is not installed.
"""
import dataclasses
import hashlib
import json
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import (SHAPES, dryrun_cells, get_config,
                                 get_smoke_config, input_specs, list_archs)
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hillclimb as HC
from repro_torch.launch import refresh_costs, roofline
from repro_torch.launch.mesh import HW, MESHES, make_mesh
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T

CELLS = dryrun_cells()


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the measured pass runs on the card)")


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules and test helpers, imported where a test
    compares with them."""
    pytest.importorskip("jax")
    import jax
    import torch_jax_trees
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import dryrun_cells as jax_cells
    from repro.configs import get_config as jax_get_config
    from repro.configs import input_specs as jax_input_specs
    from repro.launch import costmodel, hillclimb
    from repro.models import layers, sharding, transformer
    from repro.train import optimizer
    return types.SimpleNamespace(
        jax=jax, trees=torch_jax_trees, SHAPES=JSHAPES, cells=jax_cells,
        get_config=jax_get_config, input_specs=jax_input_specs,
        cost=costmodel, hillclimb=hillclimb, L=layers, SH=sharding,
        T=transformer, OPT=optimizer)


@pytest.fixture(scope="module")
def jtrees(J):
    """Each architecture's FULL parameter and optimizer shapes in the JAX
    package, once."""
    out = {}
    for arch in list_archs():
        cfg = J.get_config(arch)
        p = J.jax.eval_shape(
            lambda: J.T.init_params(cfg, J.jax.random.PRNGKey(0)))
        n = sum(x.size for x in J.jax.tree.leaves(p))
        kind = DR.pick_optimizer(n)
        o = J.jax.eval_shape(lambda: J.OPT.make_optimizer(kind).init(p))
        out[arch] = (p, o, n)
    return out


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The structural sweep of all 32 cells on the single-pod mesh,
    through the command line's entry point, into a temporary directory:
    ``(directory, {(arch, shape): JSON})``."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DR, "OUT_DIR", str(out))
        DR.main(["--all", "--mesh", "single"])
    results = {}
    for name in sorted(os.listdir(out)):
        with open(out / name) as f:
            r = json.load(f)
        results[(r["arch"], r["shape"])] = r
    return out, results


def jax_arg_bytes(J, jtrees, arch, shape_name, mesh_name, layout):
    """The JAX side's per-device argument bytes of one cell, by group,
    from the JAX specs over the JAX trees (as ``repro.launch.dryrun``'s
    ``build_cell`` lays out the step's arguments)."""
    tr, mesh = J.trees, make_mesh(mesh_name)
    jmesh = tr.stand_in(mesh_name)
    cfg, shape = J.get_config(arch), J.SHAPES[shape_name]
    p, o, _ = jtrees[arch]
    with tr.layout(layout):
        pspecs = J.SH.param_specs(cfg, p, jmesh)
        out = {"params": tr.jax_bytes(tr.jax_flat(p), tr.jax_specs(pspecs),
                                      mesh)}
        if shape.kind in ("train", "prefill"):
            b = J.input_specs(cfg, shape)
            out["batch"] = tr.jax_bytes(
                tr.jax_flat(b), tr.jax_specs(J.SH.batch_specs(cfg, b, jmesh)),
                mesh)
            if shape.kind == "train":
                ospecs = J.SH.opt_specs(pspecs, o, jmesh)
                out["opt_state"] = tr.jax_bytes(
                    tr.jax_flat(o), tr.jax_specs(ospecs), mesh)
            return out
        B, S = shape.global_batch, shape.seq_len
        c = J.jax.eval_shape(lambda: J.T.init_cache(cfg, B, S))
        cspecs = J.SH.cache_specs(cfg, c, jmesh,
                                  seq_shard=shape_name == "long_500k")
        out["cache"] = tr.jax_bytes(tr.jax_flat(c), tr.jax_specs(cspecs),
                                    mesh)
        dp = J.SH.dp_axes(jmesh)
        tok = tuple(J.SH.guard_spec(J.SH.P(dp, None), (B, 1), jmesh))
        batch = B * 4 // (np.prod([mesh.shape[a] for a in
                                   (tok[0] if isinstance(tok[0], tuple)
                                    else (tok[0],))]) if tok[0] else 1) + 4
        if cfg.enc_dec:
            e = tuple(J.SH.guard_spec(J.SH.P(dp, None, None),
                                      (B, S, cfg.d_model), jmesh))
            parts = (np.prod([mesh.shape[a] for a in
                              (e[0] if isinstance(e[0], tuple) else (e[0],))])
                     if e[0] else 1)
            batch += B * S * cfg.d_model * 2 // parts
        out["batch"] = int(batch)
        return out


# ------------------------------------------------------------ meta weights
#: sha256 (first 16 hex digits) of every SMOKE model's weights from
#: ``init_params(cfg, seed=0, device="cpu")``, names and bytes in
#: ``named_parameters`` order, as drawn before ``init_params`` learned to
#: build on ``meta``
SMOKE_DIGESTS = {
    "whisper_medium": "0817c4b90e88cbb4", "minitron_8b": "98b051c386cd8bb3",
    "qwen2_5_3b": "35180c84ebed8c28", "mistral_nemo_12b": "98b051c386cd8bb3",
    "llama3_2_3b": "50bccd6c3d0b3089", "qwen2_vl_7b": "2446b6710ff508d3",
    "grok_1_314b": "586899bda1ca03d4",
    "llama4_maverick_400b": "8e45678a662a3597",
    "jamba_1_5_large_398b": "52719c3b189b9b82",
    "xlstm_1_3b": "e0f060677354fe69"}


@pytest.mark.parametrize("arch", list_archs())
def test_full_config_builds_on_meta(J, jtrees, arch):
    """A FULL config's ``init_params`` on ``meta``: every weight a shape,
    none allocated, the JAX package's parameter count."""
    model = T.init_params(get_config(arch), device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert T.param_count(model) == jtrees[arch][2]


@pytest.mark.parametrize("arch", list_archs())
def test_smoke_init_draws_unchanged(arch):
    """On the CPU, ``init_params`` draws bit-identical weights."""
    model = T.init_params(get_smoke_config(arch), seed=0, device="cpu")
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest()[:16] == SMOKE_DIGESTS[arch]


# ------------------------------------------------------------------ configs
def test_dryrun_cells_equal_reference(J):
    assert CELLS == J.cells()
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_equal_reference(J, arch):
    """Shapes and dtypes (int32 tokens and labels, float32 enc_embeds) on
    ``meta``, for every applicable shape and a batch override."""
    cfg, jcfg = get_config(arch), J.get_config(arch)
    for name, shape in SHAPES.items():
        for override in (None, 3):
            got = input_specs(cfg, shape, batch_override=override)
            want = J.input_specs(jcfg, J.SHAPES[name],
                                 batch_override=override)
            assert list(got) == list(want)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == tuple(want[k].shape), (name, k)
                assert str(v.dtype).replace("torch.", "") == \
                    np.dtype(want[k].dtype).name


# ---------------------------------------------------------------- structure
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_equals_reference(J, jtrees, sweep, arch, shape):
    """One cell of the structural sweep against the JAX package."""
    r = sweep[1][(arch, shape)]
    jcfg, sp = J.get_config(arch), J.SHAPES[shape]
    p, _, n = jtrees[arch]
    assert r["n_params"] == n
    n_active = J.T.active_param_count(jcfg, p)
    assert r["n_active_params"] == n_active
    tokens = sp.global_batch * (1 if sp.kind == "decode" else sp.seq_len)
    if jcfg.enc_dec and sp.kind != "decode":
        tokens = sp.global_batch * (sp.seq_len
                                    + sp.seq_len // jcfg.dec_len_ratio)
    assert r["model_flops_global"] == float(
        (6 if sp.kind == "train" else 2) * n_active * tokens)
    if sp.kind == "train":
        assert r["optimizer"] == ("adafactor" if n > 50e9 else "adamw")
    assert (r["mesh"], r["n_devices"], r["layout"], r["causal_skip"]) == \
        ("single", 256, "tp", True)

    ac = J.cost.analytic_cost(jcfg, sp, 256, dp=16, tp=16, causal_skip=True)
    assert r["flops_per_device"] == ac.flops
    assert r["bytes_per_device"] == ac.hbm_bytes
    assert r["collective_bytes_per_device"] == ac.coll_bytes
    assert r["t_compute"] == ac.flops / HW["peak_flops_bf16"]
    assert r["t_memory"] == ac.hbm_bytes / HW["hbm_bw"]
    assert r["t_collective"] == ac.coll_bytes / HW["ici_bw"]
    assert r["bottleneck"] == max(
        ("compute", "memory", "collective"), key=lambda k: r[f"t_{k}"])

    want = jax_arg_bytes(J, jtrees, arch, shape, "single", "tp")
    assert r["argument_bytes"] == want
    assert r["memory"]["argument_size_in_bytes"] == sum(want.values())


@pytest.mark.parametrize("arch", ["llama3_2_3b", "grok_1_314b",
                                  "whisper_medium"])
def test_argument_bytes_every_layout_and_mesh(J, jtrees, arch):
    """A dense model, an MoE model whose 8 experts do not divide the model
    axis, and the encoder-decoder, under every layout and both meshes."""
    for lay in ("tp", "fsdp", "zero1"):
        for mesh_name in MESHES:
            for shape in ("train_4k", "decode_32k"):
                SH.set_layout(lay)
                try:
                    r = DR.run_cell(arch, shape, make_mesh(mesh_name),
                                    mesh_name, save=False, verbose=False)
                finally:
                    SH.set_layout("tp")
                assert r["layout"] == lay
                assert r["argument_bytes"] == jax_arg_bytes(
                    J, jtrees, arch, shape, mesh_name, lay), (lay, mesh_name,
                                                             shape)
                dp, tp = DR.mesh_dp_tp(MESHES[mesh_name], lay)
                ac = J.cost.analytic_cost(
                    J.get_config(arch), J.SHAPES[shape],
                    make_mesh(mesh_name).size, dp=dp, tp=tp,
                    causal_skip=True, zero1=lay == "zero1")
                assert r["flops_per_device"] == ac.flops
                assert r["bytes_per_device"] == ac.hbm_bytes


def test_round_trip(sweep, monkeypatch, capsys):
    """``refresh_costs`` rewrites every JSON of the sweep unchanged;
    ``roofline`` renders one row per cell."""
    out, results = sweep
    assert len(results) == 32 and set(results) == set(CELLS)
    monkeypatch.setattr(DR, "OUT_DIR", str(out))
    refresh_costs.main()
    for (arch, shape), r in results.items():
        with open(out / f"{arch}__{shape}__single.json") as f:
            assert json.load(f) == r, (arch, shape)
    rows = roofline.load("single")
    assert len(rows) == 32 and roofline.load("multi") == []
    text = roofline.table(rows)
    lines = text.splitlines()
    assert len(lines) == 34 and lines[0].startswith("| arch | shape |")
    assert all(line.count("|") == 15 for line in lines)
    capsys.readouterr()
    roofline.main(["--mesh", "single", "--csv"])
    assert len(capsys.readouterr().out.strip().splitlines()) == 32


def test_refresh_keeps_measured_times_and_recomputes_shares(sweep,
                                                            monkeypatch,
                                                            tmp_path):
    """A JSON with a ``measured`` block keeps its time and peak through
    ``refresh_costs``, its shares recomputed; ``roofline`` shows them."""
    _, results = sweep
    r = dict(results[("llama3_2_3b", "decode_32k")])
    m = {"B_card": 1, "seq_len": 32768, "ms": 4.0, "runs": 3,
         "peak_bytes": 2e9, "fits": True}
    m.update(DR.measured_shares(m, get_config("llama3_2_3b"), "decode"))
    r["measured"] = dict(m, compute_fraction=0.5)
    monkeypatch.setattr(DR, "OUT_DIR", str(tmp_path))
    path = DR.save_result(r)
    refresh_costs.refresh(path)
    with open(path) as f:
        got = json.load(f)
    assert got["measured"] == m
    row = roofline.table(roofline.load(), md=False).splitlines()[0]
    assert row.endswith(f",4.00,2.00,{m['compute_fraction']:.4f},"
                        f"{m['measured_fraction']:.4f}")


# -------------------------------------------------------- the measured pass
def test_measured_shares_equal_reference(J):
    """The shares' analytic cost is the JAX cost model's on one period,
    one device, ``causal_skip=True``."""
    for arch, kind, S in (("llama3_2_3b", "train", 4096),
                          ("grok_1_314b", "prefill", 32768),
                          ("xlstm_1_3b", "decode", 524288),
                          ("whisper_medium", "prefill", 32768)):
        block = {"B_card": 1, "seq_len": S, "ms": 250.0}
        got = DR.measured_shares(block, get_config(arch), kind)
        jcfg = J.get_config(arch)
        jcfg = dataclasses.replace(
            jcfg, n_layers=jcfg.period,
            n_enc_layers=jcfg.period if jcfg.enc_dec else 0)
        from repro.configs.base import ShapeSpec as JShapeSpec
        ac = J.cost.analytic_cost(jcfg, JShapeSpec("x", S, 1, kind), 1,
                                  dp=1, tp=1, causal_skip=True)
        assert (got["flops"], got["bytes"]) == (ac.flops, ac.hbm_bytes)
        t_c = ac.flops / HW["peak_flops_bf16"]
        t_m = ac.hbm_bytes / HW["hbm_bw"]
        assert got["compute_fraction"] == t_c / 0.25
        assert got["measured_fraction"] == max(t_c, t_m) / 0.25


def test_measure_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DR.measure_cell("llama3_2_3b", "decode_32k")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DR.main(["--all", "--measure"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DR.main(["--arch", "llama3_2_3b", "--shape", "decode_32k",
                 "--measure"])


def test_jamba_does_not_fit_one_card():
    """One jamba period as published needs 90.5 GB of bf16 weights, more
    than an 80 GB card; its train step also needs the gradients and the
    optimizer state."""
    one = DR.one_period(get_config("jamba_1_5_large_398b"))
    params = DR.param_leaves(T.init_params(one, device="meta"))
    weights = sum(t.numel() * t.element_size() for t in params.values())
    assert 90.0e9 < weights < 91.0e9
    need = DR._need_bytes(one, ShapeSpec("train_4k", 4096, 1, "train"),
                          "adafactor")
    assert need > 2 * weights > 80e9


@pytest.mark.parametrize("arch", ["llama3_2_3b", "whisper_medium",
                                  "jamba_1_5_large_398b", "xlstm_1_3b"])
def test_step_functions_run_on_cpu(arch):
    """The measured pass's three step functions on the CPU at SMOKE
    widths and small shapes (control flow only), with their argument
    bytes: the train step moves the weights; the prefill keeps the last
    position's logits; the decode step returns one position."""
    cfg = DR.one_period(get_smoke_config(arch))
    dev = torch.device("cpu")
    fn, args = DR._step_fn(cfg, ShapeSpec("t", 16, 2, "train"), "adafactor",
                           dev, 0)
    m1 = fn()
    m2 = fn()
    assert torch.isfinite(m1["loss"]) and torch.isfinite(m2["loss"])
    assert args > 0
    fn, _ = DR._step_fn(cfg, ShapeSpec("p", 16, 2, "prefill"), "adamw", dev,
                        0)
    assert fn().shape == (2, cfg.padded_vocab)
    fn, _ = DR._step_fn(cfg, ShapeSpec("d", 16, 2, "decode"), "adamw", dev,
                        0)
    logits, cache = fn()
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert torch.isfinite(logits).all() and len(cache) == 1


# ---------------------------------------------------------------- hillclimb
VARIANTS = [["baseline"], ["fsdp_layout"], ["zero1_layout", "causal_skip"],
            ["chunkwise"], ["chunked_mamba"], ["dense_moe"],
            ["fsdp_layout", "chunked_mamba", "dense_moe"]]


@pytest.mark.parametrize("variants", VARIANTS, ids=",".join)
def test_apply_variants_equal_reference(J, variants):
    """The same configs and layout as the JAX package's ``apply_variants``
    (``causal_skip`` is a no-op in the port, which always skips)."""
    arch = "jamba_1_5_large_398b"
    try:
        cfg = HC.apply_variants(arch, variants)
        jcfg = J.hillclimb.apply_variants(arch, variants)
        assert SH.get_layout() == J.SH.get_layout()
    finally:
        SH.set_layout("tp")
        J.SH.set_layout("tp")
        J.L.set_causal_skip(False)
    assert cfg.xlstm.chunkwise == jcfg.xlstm.chunkwise
    assert cfg.ssm.scan_impl == jcfg.ssm.scan_impl
    assert cfg.moe.ghost_dispatch == jcfg.moe.ghost_dispatch
    assert dataclasses.replace(cfg, dtype=None) == dataclasses.replace(
        get_config(arch), dtype=None, ssm=cfg.ssm, moe=cfg.moe,
        xlstm=cfg.xlstm)


def test_apply_variants_rejects():
    with pytest.raises(SystemExit, match="unknown variant"):
        HC.apply_variants("llama3_2_3b", ["pipeline"])
    with pytest.raises(ValueError, match="needs a MoE config"):
        HC.apply_variants("llama3_2_3b", ["dense_moe"])
    SH.set_layout("tp")


def test_hillclimb_main_writes_a_tagged_cell(monkeypatch, tmp_path, capsys):
    """``main`` writes ``<cell>__<variants>.json`` under the layout it
    names, which ``refresh_costs`` leaves alone."""
    monkeypatch.setattr(DR, "OUT_DIR", str(tmp_path))
    try:
        r = HC.main(["--arch", "qwen2_5_3b", "--shape", "train_4k",
                     "--variant", "fsdp_layout,causal_skip"])
    finally:
        SH.set_layout("tp")
    path = tmp_path / "qwen2_5_3b__train_4k__single__fsdp_layout+causal_skip.json"
    assert r["layout"] == "fsdp" and path.exists()
    before = path.read_text()
    refresh_costs.main()
    assert path.read_text() == before
    assert "roofline_fraction" in capsys.readouterr().out


# --------------------------------------------------------------- the card
@pytest.mark.gpu
def test_measured_cell_on_the_card(tmp_path, monkeypatch):
    """One measured cell on the card: llama3.2-3b's decode step at its
    published widths against a 32k cache."""
    need_card()
    monkeypatch.setattr(DR, "OUT_DIR", str(tmp_path))
    r = DR.run_cell("llama3_2_3b", "decode_32k", make_mesh("single"),
                    "single", measure=True)
    m = r["measured"]
    assert m["fits"] and m["runs"] >= 1 and m["ms"] > 0
    assert 0 < m["compute_fraction"] <= 1.05
    assert m["measured_fraction"] > 0
    assert m["peak_bytes"] <= torch.cuda.get_device_properties(0).total_memory
    assert m["peak_bytes"] >= m["argument_bytes"] > 0
    assert (tmp_path / "llama3_2_3b__decode_32k__single.json").exists()

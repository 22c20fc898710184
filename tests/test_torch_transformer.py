"""Parity of the port's LM (``repro_torch.models.transformer``), its
config registry and its serve loop with the JAX package's, on the
registered jamba-1.5-large SMOKE config (float32, 8 layers: 7 Mamba, attention at
index 4, MoE on the odd layers).

The JAX package's weights (``init_params`` from a PRNG key) cross over
through ``interop.model_from_arrays``, so both compute the same function.
As in ``tests/test_models_smoke.py``'s parity test, the router weights are
multiplied by 20 and the capacity factor is 8, so that near-tie expert
choices cannot flip between the frameworks and no token is dropped.
Tolerances, as max |port - JAX| over max |JAX logit|: 1e-4 for
``forward`` and ``decode_step`` (eight layers of float32 round-off in
other summation orders; the largest seen are 2.0e-5 and 1.2e-5), the
same for the port's own decode against its forward (2.6e-5 seen), and
the greedy tokens of ``generate`` equal to those of a JAX
``decode_step`` loop, its logits within 1e-4 (8.4e-6 seen).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.base import (  # noqa: E402
    shape_applicable as jax_shape_applicable)
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import execution  # noqa: E402
from repro_torch.interop import model_from_arrays  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "jamba_1_5_large_398b"
TOL = 1e-4
#: the port's scan impls and the JAX package's names for them
IMPLS = {"materialized": "materialized", "chunked": "chunked",
         "kernel": "pallas"}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _with(cfg, impl=None):
    """Ample capacity; optionally another scan impl."""
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    if impl is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, scan_impl=impl))
    return cfg


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port config, port model) for SMOKE."""
    jcfg = _with(jax_get_smoke(ARCH))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 20.0 if any(
            getattr(k, "key", None) == "router" for k in p) else x, params)
    cfg = _with(configs.get_smoke_config(ARCH))
    model = model_from_arrays(cfg, jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def jax_step(pair):
    """The JAX package's ``decode_step``, compiled once for the module."""
    jcfg = pair[0]
    return jax.jit(lambda p, c, t, n: JT.decode_step(jcfg, p, c, t, n))


def _tokens(B, S, seed=2):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def test_configs_match_the_jax_package():
    """The ten architectures, in the JAX package's order, each FULL and
    SMOKE config equal to the JAX package's field for field (the nested
    MoE, SSM and xLSTM configs too), and the same long_500k rule."""
    assert configs.list_archs() == jax_list_archs()
    assert len(configs.list_archs()) == 10
    for arch in configs.list_archs():
        for ours, theirs in ((configs.get_config(arch), jax_get_config(arch)),
                             (configs.get_smoke_config(arch),
                              jax_get_smoke(arch))):
            mine = dataclasses.asdict(ours)
            ref = dataclasses.asdict(theirs)
            assert set(mine) == set(ref)
            for field in mine:
                if field == "dtype":
                    assert str(mine[field]).split(".")[-1] == \
                        jnp.dtype(ref[field]).name
                else:
                    assert mine[field] == ref[field], (arch, field)
            assert ours.padded_vocab == theirs.padded_vocab
            assert ours.n_periods == theirs.n_periods
            assert ours.sub_quadratic == theirs.sub_quadratic
        for name, spec in configs.SHAPES.items():
            assert configs.shape_applicable(configs.get_config(arch), spec) \
                == jax_shape_applicable(jax_get_config(arch),
                                        JAX_SHAPES[name]), (arch, name)
    for name, spec in configs.SHAPES.items():
        ok, _ = configs.shape_applicable(configs.get_config(ARCH), spec)
        assert ok, name


def test_init_params_matches_the_jax_layout(pair):
    jcfg, params, cfg, _ = pair
    model = T.init_params(cfg, 0, "cpu")
    assert T.param_count(model) == JT.param_count(params)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(model.named_parameters())
    assert len(got) == len(want)
    for path, leaf in want:
        keys = [getattr(k, "key", None) for k in path]
        if keys[0] == "decoder":
            for period in range(cfg.n_periods):
                name = ".".join(["decoder", str(period)] + keys[1:])
                assert tuple(got[name].shape) == leaf.shape[1:], name
        else:
            assert tuple(got[".".join(keys)].shape) == leaf.shape
    same = T.init_params(cfg, 0, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 same.parameters()))


@pytest.mark.parametrize("impl", list(IMPLS))
def test_forward_matches_jax(pair, impl):
    jcfg, params, cfg, model = pair
    tok = _tokens(2, 16)
    want, jaux = JT.forward(dataclasses.replace(
        jcfg, ssm=dataclasses.replace(jcfg.ssm, scan_impl=IMPLS[impl])),
        params, {"tokens": jnp.asarray(tok)}, remat=False)
    execution.reset_launch_counts()
    got, aux = T.forward(_with(cfg, impl), model,
                         {"tokens": torch.from_numpy(tok)})
    assert execution.launch_counts().get("mamba_scan", 0) == 0   # CPU
    assert got.dtype == torch.float32
    assert got.shape == (2, 16, cfg.padded_vocab)
    assert _rel(got, want) <= TOL
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_decode_step_matches_jax(pair, jax_step):
    jcfg, params, cfg, model = pair
    B, S = 2, 6
    tok = _tokens(B, S, seed=5)
    jc = JT.init_cache(jcfg, B, S + 2)
    tc = T.init_cache(cfg, B, S + 2, "cpu")
    for t in range(S):
        want, jc = jax_step(params, jc, jnp.asarray(tok[:, t:t + 1]), t)
        got, tc = T.decode_step(cfg, model, tc,
                                torch.from_numpy(tok[:, t:t + 1]), t)
        assert got.shape == (B, 1, cfg.padded_vocab)
        assert _rel(got, want) <= TOL, t


@pytest.mark.parametrize("impl", ["kernel", "materialized"])
def test_decode_matches_forward(pair, impl):
    """The port's counterpart of ``test_models_smoke.py``'s parity test:
    token-by-token decode logits equal the full forward's at every
    position."""
    _, _, cfg, model = pair
    cfg = _with(cfg, impl)
    B, S = 1, 8
    tok = torch.from_numpy(_tokens(B, S))
    ref, _ = T.forward(cfg, model, {"tokens": tok})
    cache = T.init_cache(cfg, B, S + 2, "cpu")
    outs = []
    for t in range(S):
        logits, cache = T.decode_step(cfg, model, cache, tok[:, t:t + 1], t)
        outs.append(logits[:, 0])
    assert _rel(torch.stack(outs, dim=1), ref.numpy()) <= TOL


def test_generate_matches_a_jax_decode_loop(pair, jax_step):
    """``serve.generate`` against ``repro/launch/serve.py``'s loop, run
    here with the JAX package's ``decode_step``: the same greedy tokens,
    and the logits each token was taken from within tolerance."""
    jcfg, params, cfg, model = pair
    B, P, gen = 2, 5, 7
    prompts = _tokens(B, P, seed=9)
    out = serve.generate(cfg, model, torch.from_numpy(prompts), gen)
    assert out.tokens.shape == (B, gen) and out.logits.shape == (
        B, gen, cfg.padded_vocab)

    cache = JT.init_cache(jcfg, B, P + gen)
    for t in range(P):
        logits, cache = jax_step(params, cache,
                                 jnp.asarray(prompts[:, t:t + 1]), t)
    tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], -1).astype(jnp.int32)
    toks, outs = [np.asarray(tok)], [np.asarray(logits)]
    for t in range(P, P + gen - 1):
        logits, cache = jax_step(params, cache, tok, t)
        tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        outs.append(np.asarray(logits))
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.concatenate(toks, axis=1))
    assert _rel(out.logits, np.concatenate(outs, axis=1)) <= TOL


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
                "3", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serve OK" in out and "device=cpu" in out


def test_unported_parts_raise(pair):
    """What the port refuses: a depth that is not whole periods (decoder
    or encoder), an unknown mixer, an MoE slot without an MoE config,
    weights whose entries or periods do not match the config, an unknown
    scan and an empty generation.  Every mixer and the encoder-decoder
    stack are ported, so nothing raises ``NotImplementedError`` any
    more."""
    cfg = configs.get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="multiple"):
        T.init_params(dataclasses.replace(cfg, n_layers=5), 0, "cpu")
    with pytest.raises(ValueError, match="n_enc_layers=5 not a multiple"):
        T.init_params(dataclasses.replace(cfg, enc_dec=True, n_enc_layers=5),
                      0, "cpu")
    with pytest.raises(ValueError, match="conv"):
        T.init_params(dataclasses.replace(cfg, pattern=(("conv", "mlp"),),
                                          n_layers=1), 0, "cpu")
    with pytest.raises(ValueError, match="needs cfg.moe"):
        T.init_params(dataclasses.replace(cfg, moe=None), 0, "cpu")
    jcfg, params, _, _ = pair
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="do not match"):
        model_from_arrays(dataclasses.replace(
            cfg, pattern=cfg.pattern[:4], n_layers=4), tree, "cpu")
    with pytest.raises(ValueError, match=r"\[1\] periods of decoder weights"):
        model_from_arrays(dataclasses.replace(cfg, n_layers=16), tree, "cpu")
    with pytest.raises(ValueError, match="scan_impl"):
        T.forward(_with(cfg, "pallas"), T.init_params(cfg, 0, "cpu"),
                  {"tokens": torch.zeros((1, 2), dtype=torch.long)})
    with pytest.raises(ValueError, match="at least 1"):
        serve.generate(cfg, T.init_params(cfg, 0, "cpu"),
                       torch.zeros((1, 2), dtype=torch.long), 0)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--smoke"])

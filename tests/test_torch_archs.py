"""Parity of the port's seven decoder-only architectures (llama3.2-3b,
qwen2.5-3b, minitron-8b, mistral-nemo-12b, qwen2-vl-7b, grok-1 and
llama4-maverick) with the JAX package's, on their registered float32
SMOKE configs.

The JAX package's weights (``init_params`` from a PRNG key) cross over
through ``interop.model_from_arrays``, so both packages compute the same
function; each architecture's JAX results are computed once, in a
module-scoped fixture.  For the two MoE models the router weights are
multiplied by 20 and the capacity factor is 8, as in
``tests/test_models_smoke.py``'s parity test, so near-tie expert choices
cannot flip between the frameworks and no token is dropped.

Tolerances, as max |port - JAX| / max |JAX logit|: 1e-4 for ``forward``
and for every ``decode_step`` (two layers of float32 round-off in other
summation orders; the largest seen are 3.8e-6 and 8.8e-7), and the
greedy tokens of ``generate`` equal to those of a JAX ``decode_step``
loop, its logits within 1e-4 (4.5e-6 seen).  One more case runs
mistral-nemo's SMOKE config with ``head_dim`` 8 where d_model / n_heads
is 16, as its FULL config has 128 where d_model / n_heads is 160.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import model_from_arrays  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ["llama3_2_3b", "qwen2_5_3b", "minitron_8b", "mistral_nemo_12b",
         "qwen2_vl_7b", "grok_1_314b", "llama4_maverick_400b"]
TOL = 1e-4
B, S, DECODE, PROMPT, GEN = 2, 16, 6, 5, 7
MAX_LEN = PROMPT + GEN


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ample(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _sharp_router(params):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x * 20.0 if any(
            getattr(k, "key", None) == "router" for k in p) else x, params)


def _jax_decode_loop(jcfg, step, params, tokens, gen):
    """``repro/launch/serve.py``'s loop with the JAX package's
    ``decode_step`` (``step``, compiled): the prompt's logits at every
    position, then the greedy tokens and the logits each was taken from.
    The cache has ``MAX_LEN`` positions, so ``step`` compiles once."""
    Bt, P = tokens.shape
    cache = JT.init_cache(jcfg, Bt, MAX_LEN)
    steps = []
    for t in range(P):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                             t)
        steps.append(np.asarray(logits))
    tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], -1).astype(jnp.int32)
    toks, outs = [np.asarray(tok)], [np.asarray(logits)]
    for t in range(P, P + gen - 1):
        logits, cache = step(params, cache, tok, t)
        tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        outs.append(np.asarray(logits))
    return (np.concatenate(steps, axis=1), np.concatenate(toks, axis=1),
            np.concatenate(outs, axis=1))


def _case(jcfg, cfg):
    """Both packages' models on the JAX weights, and the JAX results."""
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.moe is not None:
        params = _sharp_router(params)
    model = model_from_arrays(cfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    forward, aux = JT.forward(jcfg, params, {"tokens": jnp.asarray(tokens)},
                              remat=False)
    step = jax.jit(lambda p, c, t, n: JT.decode_step(jcfg, p, c, t, n))
    decode, _, _ = _jax_decode_loop(jcfg, step, params, tokens[:, :DECODE],
                                    1)
    _, gen_toks, gen_logits = _jax_decode_loop(jcfg, step, params, prompts,
                                               GEN)
    return dict(jcfg=jcfg, params=params, cfg=cfg, model=model,
                tokens=tokens, prompts=prompts, forward=np.asarray(forward),
                aux=float(aux), decode=decode, gen_toks=gen_toks,
                gen_logits=gen_logits)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    return _case(_ample(jax_get_smoke(arch)),
                 _ample(configs.get_smoke_config(arch)))


@pytest.fixture(scope="module")
def wide_heads():
    """mistral-nemo's SMOKE config with head_dim 8 (d_model / n_heads is
    16), made with ``dataclasses.replace`` on both sides."""
    arch = "mistral_nemo_12b"
    return _case(dataclasses.replace(jax_get_smoke(arch), head_dim=8),
                 dataclasses.replace(configs.get_smoke_config(arch),
                                     head_dim=8))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_field_for_field(arch):
    for ours, theirs in ((configs.get_config(arch), jax_get_config(arch)),
                         (configs.get_smoke_config(arch),
                          jax_get_smoke(arch))):
        mine, ref = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert set(mine) == set(ref)
        for field in ref:
            if field == "dtype":
                assert str(mine[field]).split(".")[-1] == \
                    jnp.dtype(ref[field]).name
            else:
                assert mine[field] == ref[field], field
        assert (ours.hd, ours.padded_vocab, ours.n_periods) == (
            theirs.hd, theirs.padded_vocab, theirs.n_periods)


def test_param_counts_match(case):
    jcfg, params, cfg, model = (case[k] for k in ("jcfg", "params", "cfg",
                                                  "model"))
    assert T.param_count(model) == JT.param_count(params)
    assert T.active_param_count(cfg, model) == \
        JT.active_param_count(jcfg, params)
    fresh = T.init_params(cfg, 0, "cpu")
    assert T.param_count(fresh) == JT.param_count(params)
    if cfg.moe is not None:
        assert T.active_param_count(cfg, fresh) < T.param_count(fresh)


def test_forward_matches_jax(case):
    cfg, model = case["cfg"], case["model"]
    got, aux = T.forward(cfg, model, {"tokens": torch.from_numpy(
        case["tokens"])})
    assert got.dtype == torch.float32
    assert got.shape == (B, S, cfg.padded_vocab)
    assert _rel(got, case["forward"]) <= TOL
    assert abs(float(aux) - case["aux"]) <= 1e-5 * max(abs(case["aux"]),
                                                       1e-30)


def test_decode_step_matches_jax(case):
    cfg, model = case["cfg"], case["model"]
    tok = torch.from_numpy(case["tokens"])
    cache = T.init_cache(cfg, B, DECODE + 1, "cpu")
    for t in range(DECODE):
        got, cache = T.decode_step(cfg, model, cache, tok[:, t:t + 1], t)
        assert got.shape == (B, 1, cfg.padded_vocab)
        assert _rel(got[:, 0], case["decode"][:, t]) <= TOL, t


def test_generate_matches_a_jax_decode_loop(case):
    cfg, model = case["cfg"], case["model"]
    out = serve.generate(cfg, model, torch.from_numpy(case["prompts"]), GEN)
    np.testing.assert_array_equal(out.tokens.numpy(), case["gen_toks"])
    assert _rel(out.logits, case["gen_logits"]) <= TOL


def test_head_dim_other_than_d_model_over_heads(wide_heads):
    cfg, model = wide_heads["cfg"], wide_heads["model"]
    assert cfg.hd == 8 != cfg.d_model // cfg.n_heads
    assert tuple(model.decoder[0]["l0_mix"]["attn"]["wq"].shape) == (
        cfg.d_model, cfg.n_heads * 8)
    tok = torch.from_numpy(wide_heads["tokens"])
    got, _ = T.forward(cfg, model, {"tokens": tok})
    assert _rel(got, wide_heads["forward"]) <= TOL
    cache = T.init_cache(cfg, B, DECODE + 1, "cpu")
    assert tuple(cache[0]["l0"]["self"][0].shape) == (
        B, DECODE + 1, cfg.n_kv_heads, 8)
    for t in range(DECODE):
        step, cache = T.decode_step(cfg, model, cache, tok[:, t:t + 1], t)
        assert _rel(step[:, 0], wide_heads["decode"][:, t]) <= TOL, t


def test_full_head_dims():
    """The FULL configs' attention widths: mistral-nemo's 32 heads of 128
    project d_model 5120 to 4096, not to d_model."""
    nemo = configs.get_config("mistral_nemo_12b")
    assert (nemo.hd, nemo.n_heads * nemo.hd, nemo.d_model) == (128, 4096,
                                                               5120)
    vl = configs.get_config("qwen2_vl_7b")
    assert sum(vl.mrope_sections) == vl.hd // 2

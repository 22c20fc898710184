"""Parity of the port's xLSTM blocks (``repro_torch.models.xlstm``) and of
the xlstm-1.3b SMOKE model with the JAX package's, in float32.

The blocks' weights are the JAX package's ``mlstm_init``/``slstm_init``
arrays, carried across leaf by leaf (the gate weights ``wi``, ``wf``,
``bi``, ``bf`` and sLSTM's ``r``, ``b`` are float32 whatever the model's
dtype); the model's cross through ``interop.model_from_arrays``.  Inputs
come from a seeded numpy generator; each JAX result is computed once, in
a module-scoped fixture.

Tolerances, as max |port - JAX| / max |JAX|: 1e-4 everywhere (float32
round-off of the recurrences in other summation orders; the largest seen
is 2.3e-5, the SMOKE model's forward through eight recurrent layers):
``mlstm_apply`` recurrent and chunkwise with S not a multiple of the
chunk, ``slstm_apply`` over more than one 256-step chunk, both decode
steps, the model's ``forward`` and ``decode_step``, and the port's decode
against its own forward.  ``generate``'s greedy tokens equal a JAX
``decode_step`` loop's.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import (model_from_arrays,  # noqa: E402
                                 tensor_from_array)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models.layers import params as to_params  # noqa: E402

ARCH = "xlstm_1_3b"
TOL = 1e-4
D = 32                       # block width of the block tests
#: the block tests' config: 4 heads of dh 16, chunks of 8 steps
CFG = dict(n_heads=4, expand=2, chunk=8)
B, S_MLSTM, S_SLSTM, STEPS = 2, 21, 300, 5
S_MODEL, PROMPT, GEN = 12, 4, 6


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port(tree):
    return to_params(**{k: tensor_from_array(np.asarray(v), "cpu")
                        for k, v in tree.items()})


def _x(rng, S):
    return rng.standard_normal((B, S, D)).astype(np.float32)


@pytest.fixture(scope="module")
def blocks():
    """The JAX package's mLSTM and sLSTM weights and results."""
    rng = np.random.default_rng(5)
    jcfg, jcw = JX.XLSTMConfig(**CFG), JX.XLSTMConfig(**CFG, chunkwise=True)
    mp = JX.mlstm_init(jax.random.PRNGKey(1), D, jcfg, jnp.float32)
    sp = JX.slstm_init(jax.random.PRNGKey(2), D, jcfg, jnp.float32)
    xm, xs = _x(rng, S_MLSTM), _x(rng, S_SLSTM)
    xd = _x(rng, STEPS)
    out = dict(mp=mp, sp=sp, xm=xm, xs=xs, xd=xd,
               mlstm=np.asarray(JX.mlstm_apply(mp, jnp.asarray(xm), jcfg)),
               mlstm_cw=np.asarray(JX.mlstm_apply(mp, jnp.asarray(xm), jcw)),
               slstm=np.asarray(JX.slstm_apply(sp, jnp.asarray(xs), jcfg)))
    for kind, init, step, p in (("m", JX.mlstm_decode_init,
                                 JX.mlstm_decode_step, mp),
                                ("s", JX.slstm_decode_init,
                                 JX.slstm_decode_step, sp)):
        st, outs, states = init(B, D, jcfg), [], []
        for t in range(STEPS):
            y, st = step(p, jnp.asarray(xd[:, t:t + 1]), st, jcfg)
            outs.append(np.asarray(y))
            states.append(jax.tree.map(np.asarray, st))
        out[f"{kind}_steps"], out[f"{kind}_states"] = outs, states
    return out


@pytest.mark.parametrize("chunkwise", [False, True],
                         ids=["recurrent", "chunkwise"])
def test_mlstm_apply_matches_jax(blocks, chunkwise):
    assert S_MLSTM % CFG["chunk"] != 0
    cfg = X.XLSTMConfig(**CFG, chunkwise=chunkwise)
    got = X.mlstm_apply(_port(blocks["mp"]), torch.from_numpy(blocks["xm"]),
                        cfg)
    assert _rel(got, blocks["mlstm_cw" if chunkwise else "mlstm"]) <= TOL


def test_mlstm_forms_agree():
    """The chunkwise form against the recurrent one in the port alone, at
    a length of several chunks and a partial one."""
    rng = np.random.default_rng(6)
    p = X.mlstm_init(torch.Generator().manual_seed(0), D,
                     X.XLSTMConfig(**CFG), torch.float32)
    x = torch.from_numpy(_x(rng, 45))
    rec = X.mlstm_apply(p, x, X.XLSTMConfig(**CFG))
    cw = X.mlstm_apply(p, x, X.XLSTMConfig(**CFG, chunkwise=True))
    assert _rel(cw, rec) <= TOL


def test_slstm_apply_matches_jax(blocks):
    assert S_SLSTM > 256
    got = X.slstm_apply(_port(blocks["sp"]), torch.from_numpy(blocks["xs"]),
                        X.XLSTMConfig(**CFG))
    assert _rel(got, blocks["slstm"]) <= TOL


@pytest.mark.parametrize("kind", ["m", "s"], ids=["mlstm", "slstm"])
def test_decode_steps_match_jax(blocks, kind):
    cfg = X.XLSTMConfig(**CFG)
    init, step, p = ((X.mlstm_decode_init, X.mlstm_decode_step, blocks["mp"])
                     if kind == "m" else
                     (X.slstm_decode_init, X.slstm_decode_step, blocks["sp"]))
    st, p = init(B, D, cfg, "cpu"), _port(p)
    assert set(st) == set(blocks[f"{kind}_states"][0])
    for t in range(STEPS):
        y, st = step(p, torch.from_numpy(blocks["xd"][:, t:t + 1]), st, cfg)
        assert y.shape == (B, 1, D)
        assert _rel(y, blocks[f"{kind}_steps"][t]) <= TOL, t
        for name, want in blocks[f"{kind}_states"][t].items():
            assert st[name].dtype == torch.float32, name
            assert np.abs(st[name].numpy() - want).max() <= TOL * max(
                np.abs(want).max(), 1.0), (t, name)


def test_slstm_recurrent_weights_stay_float32():
    cfg = X.XLSTMConfig(**CFG)
    p = X.slstm_init(torch.Generator().manual_seed(0), D, cfg, torch.bfloat16)
    assert {k: v.dtype for k, v in p.items()} == {
        "wx": torch.bfloat16, "r": torch.float32, "b": torch.float32,
        "out": torch.bfloat16}
    m = X.mlstm_init(torch.Generator().manual_seed(0), D, cfg,
                     torch.bfloat16)
    assert {k for k, v in m.items() if v.dtype == torch.float32} == {
        "wi", "wf", "bi", "bf"}


@pytest.fixture(scope="module")
def model_case():
    jcfg = jax_get_smoke(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = model_from_arrays(cfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_MODEL)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    forward, _ = JT.forward(jcfg, params, {"tokens": jnp.asarray(tokens)},
                            remat=False)
    step = jax.jit(lambda p, c, t, n: JT.decode_step(jcfg, p, c, t, n))
    cache = JT.init_cache(jcfg, B, PROMPT + GEN)
    decode = []
    for t in range(STEPS):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                             t)
        decode.append(np.asarray(logits[:, 0]))
    cache = JT.init_cache(jcfg, B, PROMPT + GEN)
    for t in range(PROMPT):
        logits, cache = step(params, cache,
                             jnp.asarray(prompts[:, t:t + 1]), t)
    tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], -1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    for t in range(PROMPT, PROMPT + GEN - 1):
        logits, cache = step(params, cache, tok, t)
        tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    return dict(jcfg=jcfg, params=params, cfg=cfg, model=model,
                tokens=tokens, prompts=prompts, forward=np.asarray(forward),
                decode=np.stack(decode, axis=1),
                gen_toks=np.concatenate(toks, axis=1))


def test_model_layout_and_counts(model_case):
    cfg, model, params = (model_case[k] for k in ("cfg", "model", "params"))
    assert [m for m, _ in cfg.pattern].count("slstm") == 1
    assert T.param_count(model) == JT.param_count(params)
    assert T.active_param_count(cfg, model) == T.param_count(model)
    assert model.decoder[0]["l7_mix"]["slstm"]["r"].dtype == torch.float32
    assert len(model.decoder[0]["l0_ffn"]) == 0
    assert T.param_count(T.init_params(cfg, 0, "cpu")) == \
        JT.param_count(params)


@pytest.mark.parametrize("chunkwise", [False, True],
                         ids=["recurrent", "chunkwise"])
def test_model_forward_matches_jax(model_case, chunkwise):
    cfg, model = model_case["cfg"], model_case["model"]
    cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(
        cfg.xlstm, chunkwise=chunkwise))
    got, aux = T.forward(cfg, model, {"tokens": torch.from_numpy(
        model_case["tokens"])})
    assert got.shape == (B, S_MODEL, cfg.padded_vocab)
    assert _rel(got, model_case["forward"]) <= TOL
    assert float(aux) == 0.0


def test_model_decode_step_matches_jax(model_case):
    cfg, model = model_case["cfg"], model_case["model"]
    tok = torch.from_numpy(model_case["tokens"])
    cache = T.init_cache(cfg, B, PROMPT + GEN, "cpu")
    assert set(cache[0]["l0"]) == {"mlstm"} and set(cache[0]["l7"]) == {
        "slstm"}
    for t in range(STEPS):
        got, cache = T.decode_step(cfg, model, cache, tok[:, t:t + 1], t)
        assert _rel(got[:, 0], model_case["decode"][:, t]) <= TOL, t


def test_model_decode_matches_its_forward(model_case):
    cfg, model = model_case["cfg"], model_case["model"]
    tok = torch.from_numpy(model_case["tokens"])
    ref, _ = T.forward(cfg, model, {"tokens": tok})
    cache = T.init_cache(cfg, B, S_MODEL, "cpu")
    outs = []
    for t in range(S_MODEL):
        logits, cache = T.decode_step(cfg, model, cache, tok[:, t:t + 1], t)
        outs.append(logits[:, 0])
    assert _rel(torch.stack(outs, dim=1), ref) <= TOL


def test_model_generate_matches_a_jax_decode_loop(model_case):
    cfg, model = model_case["cfg"], model_case["model"]
    out = serve.generate(cfg, model, torch.from_numpy(model_case["prompts"]),
                         GEN)
    np.testing.assert_array_equal(out.tokens.numpy(), model_case["gen_toks"])


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
                "3", "--gen", "3", "--device", "cpu"])
    assert "serve OK" in capsys.readouterr().out

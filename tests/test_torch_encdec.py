"""Parity of the port's encoder-decoder model (whisper-medium) with the JAX
package's, on its registered float32 SMOKE config (2 encoder and 2
decoder layers, layernorm, GELU, sinusoidal positions, tied head).

The JAX package's weights cross over through
``interop.model_from_arrays`` (the encoder stacked over its own periods,
``enc_norm``, and the decoder's ``xnorm``/``xattn``); the JAX results
are computed once, in a module-scoped fixture.  The frame embeddings
(``enc_embeds``) and the encoder states handed to decode come from a
seeded numpy generator, as the serving stub does.

Tolerances, as max |port - JAX| / max |JAX|: 1e-4 for ``forward``, the
encoder alone, every ``decode_step`` with the encoder's states, and the
port's own decode against its forward (float32 round-off of four
layers in other summation orders; the largest seen is 4.8e-7); the
greedy tokens of ``generate`` equal to a JAX ``decode_step`` loop's.
The port adds the sinusoidal row of each decode position alone where the
JAX decode builds the whole ``max_position``-row table: that row equals
the table's.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import model_from_arrays  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "whisper_medium"
TOL = 1e-4
B, S_ENC, S_DEC, PROMPT, GEN = 2, 24, 6, 4, 6


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def case():
    jcfg = jax_get_smoke(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = model_from_arrays(cfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_DEC)).astype(np.int32)
    embeds = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)

    forward, _ = JT.forward(jcfg, params, {"tokens": jnp.asarray(tokens),
                                           "enc_embeds": jnp.asarray(embeds)},
                            remat=False)
    e = jnp.asarray(embeds) + JL.sinusoidal_positions(S_ENC,
                                                      jcfg.d_model)[None]
    e, _ = JT._run_stack(jcfg, params["encoder"], e, causal=False,
                         positions=None, positions3=None, remat=False)
    enc = JL.apply_norm(jcfg.norm, params["enc_norm"], e)

    step = jax.jit(lambda p, c, t, n, x: JT.decode_step(jcfg, p, c, t, n,
                                                        enc_out=x))
    cache = JT.init_cache(jcfg, B, PROMPT + GEN)
    decode = []
    for t in range(S_DEC):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                             t, enc)
        decode.append(np.asarray(logits[:, 0]))
    cache = JT.init_cache(jcfg, B, PROMPT + GEN)
    for t in range(PROMPT):
        logits, cache = step(params, cache,
                             jnp.asarray(prompts[:, t:t + 1]), t, enc)
    tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], -1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    for t in range(PROMPT, PROMPT + GEN - 1):
        logits, cache = step(params, cache, tok, t, enc)
        tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    return dict(jcfg=jcfg, params=params, cfg=cfg, model=model,
                tokens=tokens, embeds=embeds, prompts=prompts,
                forward=np.asarray(forward), enc=np.array(enc),
                decode=np.stack(decode, axis=1),
                gen_toks=np.concatenate(toks, axis=1))


def test_config_and_layout(case):
    jcfg, params, cfg, model = (case[k] for k in ("jcfg", "params", "cfg",
                                                  "model"))
    assert cfg.enc_dec and T.n_enc_periods(cfg) == 2
    assert len(model.encoder) == 2 and len(model.decoder) == 2
    assert "xattn" in model.decoder[0]["l0_mix"]
    assert "xattn" not in model.encoder[0]["l0_mix"]
    assert T.param_count(model) == JT.param_count(params)
    assert T.active_param_count(cfg, model) == \
        JT.active_param_count(jcfg, params)
    fresh = T.init_params(cfg, 0, "cpu")
    assert T.param_count(fresh) == JT.param_count(params)
    assert set(dict(fresh.named_parameters())) == set(
        dict(model.named_parameters()))


def test_forward_matches_jax(case):
    cfg, model = case["cfg"], case["model"]
    got, aux = T.forward(cfg, model, {
        "tokens": torch.from_numpy(case["tokens"]),
        "enc_embeds": torch.from_numpy(case["embeds"])})
    assert got.shape == (B, S_DEC, cfg.padded_vocab)
    assert _rel(got, case["forward"]) <= TOL
    assert float(aux) == 0.0


def test_encoder_alone_matches_jax(case):
    enc, aux = T.encode(case["cfg"], case["model"],
                        torch.from_numpy(case["embeds"]))
    assert enc.shape == (B, S_ENC, case["cfg"].d_model)
    assert _rel(enc, case["enc"]) <= TOL
    assert float(aux) == 0.0


def test_decode_step_with_encoder_states_matches_jax(case):
    cfg, model = case["cfg"], case["model"]
    enc = torch.from_numpy(case["enc"])
    tok = torch.from_numpy(case["tokens"])
    cache = T.init_cache(cfg, B, PROMPT + GEN, "cpu", enc_len=S_ENC)
    for t in range(S_DEC):
        got, cache = T.decode_step(cfg, model, cache, tok[:, t:t + 1], t,
                                   enc_out=enc)
        assert _rel(got[:, 0], case["decode"][:, t]) <= TOL, t


def test_decode_matches_forward(case):
    """Decode through the cache, with the encoder's states of the same
    frame embeddings, equals the full forward at every position."""
    cfg, model = case["cfg"], case["model"]
    tok = torch.from_numpy(case["tokens"])
    ref, _ = T.forward(cfg, model, {
        "tokens": tok, "enc_embeds": torch.from_numpy(case["embeds"])})
    enc, _ = T.encode(cfg, model, torch.from_numpy(case["embeds"]))
    cache = T.init_cache(cfg, B, S_DEC, "cpu")
    outs = []
    for t in range(S_DEC):
        logits, cache = T.decode_step(cfg, model, cache, tok[:, t:t + 1], t,
                                      enc_out=enc)
        outs.append(logits[:, 0])
    assert _rel(torch.stack(outs, dim=1), ref) <= TOL


def test_generate_matches_a_jax_decode_loop(case):
    cfg, model = case["cfg"], case["model"]
    out = serve.generate(cfg, model, torch.from_numpy(case["prompts"]), GEN,
                         enc_out=torch.from_numpy(case["enc"]))
    np.testing.assert_array_equal(out.tokens.numpy(), case["gen_toks"])


@pytest.mark.parametrize("pos", [0, 1, 37, 4095, (1 << 20) - 1])
def test_sinusoidal_row_equals_the_table(pos):
    """The row that decode adds at position ``pos`` equals the full
    table's row, as the port computes the table and as the JAX package
    does (within float32 round-off of sin/cos of the same angle)."""
    d = 16
    row = L.sinusoidal_positions(1, d, start=pos)[0]
    table = L.sinusoidal_positions(pos + 1, d)
    assert torch.equal(row, table[pos])
    if pos < 4096:
        want = np.asarray(JL.sinusoidal_positions(4096, d))[pos]
        assert np.abs(row.numpy() - want).max() <= 2e-6


def test_decode_adds_only_its_own_row():
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), d_model=8)
    model = T.init_params(dataclasses.replace(cfg, n_heads=2, n_kv_heads=2),
                          0, "cpu")
    x, _, _ = T._embed(model.cfg, model, torch.zeros((1, 1), dtype=torch.long),
                       12345)
    want = model.embed["table"][0] + L.sinusoidal_positions(12346, 8)[12345]
    assert torch.equal(x[0, 0], want)


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
                "3", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serve OK" in out and "device=cpu" in out and "whisper" in out

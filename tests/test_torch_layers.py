"""Parity of the port's LM layers (``repro_torch.models.layers``) with the
JAX package's (``repro.models.layers``).

The same numpy weights and inputs, made from a seed, go through both.
Tolerances, as max |port - JAX| over max |JAX|: float32 2e-6 (the same
operations, with sums and the online softmax's exponentials taken in
other orders; the largest seen is 5e-7, in attention), and for bfloat16
results one unit of the last place, 2^-7, because the two frameworks may
round a float32 value on opposite sides (the largest seen is 2^-10).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.interop import tensor_from_array  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ml_dtypes = pytest.importorskip("ml_dtypes")

NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -7}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale else 1.0))


def _t(a):
    return tensor_from_array(a, "cpu")


def _both(named, dtype="float32"):
    """numpy arrays -> (JAX dict, port ParameterDict)."""
    arrs = {k: np.asarray(v).astype(NP[dtype]) for k, v in named.items()}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            L.params(**{k: _t(v) for k, v in arrs.items()}))


def _x(rng, shape, dtype="float32", scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(NP[dtype])
    return jnp.asarray(a), _t(a)


def test_dense_init_scale_and_dtype():
    g = torch.Generator().manual_seed(0)
    w = L.dense_init(g, 256, (256, 512), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 512)
    assert abs(w.float().std().item() * 16.0 - 1.0) < 0.02
    w2 = L.dense_init(torch.Generator().manual_seed(0), 256, (256, 512),
                      torch.bfloat16)
    assert torch.equal(w, w2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(rng, kind, dtype):
    d = 48
    named = {"scale": 1.0 + 0.1 * rng.standard_normal(d)}
    if kind == "layernorm":
        named["bias"] = 0.1 * rng.standard_normal(d)
    jp, tp = _both(named)                   # norm weights stay float32
    jx, tx = _x(rng, (2, 5, d), dtype, scale=3.0)
    got = L.apply_norm(kind, tp, tx)
    assert got.dtype == tx.dtype
    assert _rel(got.float(), JL.apply_norm(kind, jp, jx)) <= TOL[dtype]
    init = L.norm_init(kind, d)
    assert set(init) == set(JL.norm_init(kind, d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(rng, dtype):
    jx, tx = _x(rng, (2, 7, 3, 16), dtype)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    got = L.apply_rope(tx, torch.from_numpy(pos), 500000.0)
    want = JL.apply_rope(jx, jnp.asarray(pos), 500000.0)
    assert _rel(got.float(), want) <= TOL[dtype]


def test_mrope(rng):
    jx, tx = _x(rng, (2, 6, 2, 32), "float32")
    pos3 = rng.integers(0, 300, (2, 6, 3)).astype(np.int32)
    sections = (4, 6, 6)
    got = L.apply_mrope(tx, torch.from_numpy(pos3), sections)
    want = JL.apply_mrope(jx, jnp.asarray(pos3), sections)
    assert _rel(got, want) <= 8e-6
    with pytest.raises(ValueError, match="sections"):
        L.apply_mrope(tx, torch.from_numpy(pos3), (4, 4, 4))


def test_sinusoidal_positions():
    got = L.sinusoidal_positions(37, 24)
    assert _rel(got, JL.sinusoidal_positions(37, 24)) <= 2e-6


def _attn_weights(rng, d, H, Hkv, hd, bias, dtype):
    named = {"wq": rng.standard_normal((d, H * hd)) / np.sqrt(d),
             "wk": rng.standard_normal((d, Hkv * hd)) / np.sqrt(d),
             "wv": rng.standard_normal((d, Hkv * hd)) / np.sqrt(d),
             "wo": rng.standard_normal((H * hd, d)) / np.sqrt(H * hd)}
    if bias:
        for k, n in (("bq", H), ("bk", Hkv), ("bv", Hkv)):
            named[k] = 0.1 * rng.standard_normal(n * hd)
    return _both(named, dtype)


ATTN_CASES = [
    # (S, H, Hkv, rope, causal, bias, kv_block)
    (9, 4, 2, "rope", True, False, 1024),     # GQA, online path
    (9, 4, 4, "none", True, True, 1024),      # MHA with qkv bias
    (300, 4, 1, "rope", True, False, 128),    # MQA, several q and kv blocks
    (300, 4, 2, "none", False, False, 128),   # bidirectional
    (3, 4, 2, "rope", True, False, 1024),     # S <= 4: direct path
    (2, 4, 2, "mrope", True, False, 1024),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Hkv,rope,causal,bias,kv_block", ATTN_CASES)
def test_attention(rng, S, H, Hkv, rope, causal, bias, kv_block, dtype):
    d, hd, B = 32, 32, 2
    jp, tp = _attn_weights(rng, d, H, Hkv, hd, bias, dtype)
    jx, tx = _x(rng, (B, S, d), dtype)
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=hd, rope=rope, causal=causal,
              kv_block=kv_block, rope_theta=10000.0,
              mrope_sections=(4, 6, 6))
    jkw, tkw = dict(kw), dict(kw)
    if rope == "mrope":
        pos3 = rng.integers(0, 50, (B, S, 3)).astype(np.int32)
        jkw["positions3"] = jnp.asarray(pos3)
        tkw["positions3"] = torch.from_numpy(pos3)
    want, (jk, jv) = JL.attention_apply(jp, jx, **jkw)
    got, (tk, tv) = L.attention_apply(tp, tx, **tkw)
    assert got.dtype == tx.dtype
    assert _rel(got.float(), want) <= TOL[dtype]
    assert _rel(tk.float(), jk) <= TOL[dtype]
    assert _rel(tv.float(), jv) <= TOL[dtype]


@pytest.mark.parametrize("S", [1, 6])
def test_attention_with_cache(rng, S):
    """Decode (S=1, direct path) and a chunk of prefill (S=6, online path
    with a query offset) against a cache that already holds 5 positions."""
    d, hd, H, Hkv, B, max_len, filled = 32, 16, 4, 2, 2, 16, 5
    jp, tp = _attn_weights(rng, d, H, Hkv, hd, False, "float32")
    jx, tx = _x(rng, (B, S, d))
    ck = rng.standard_normal((B, max_len, Hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((B, max_len, Hkv, hd)).astype(np.float32)
    ck[:, filled + S:] = 0.0
    cv[:, filled + S:] = 0.0
    pos = np.broadcast_to(filled + np.arange(S), (B, S)).astype(np.int32)
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=hd, rope="rope", causal=True,
              cache_len=filled)
    want, (jck, jcv) = JL.attention_apply(
        jp, jx, positions=jnp.asarray(pos), kv_cache=(jnp.asarray(ck),
                                                      jnp.asarray(cv)), **kw)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (nk, nv) = L.attention_apply(
        tp, tx, positions=torch.from_numpy(pos), kv_cache=(tck, tcv), **kw)
    assert nk is tck and nv is tcv          # written in place
    assert _rel(got, want) <= 2e-6
    assert _rel(nk, jck) <= 2e-6 and _rel(nv, jcv) <= 2e-6


def test_cross_attention(rng):
    d, hd, H, Hkv, B = 32, 16, 4, 2, 2
    jp, tp = _attn_weights(rng, d, H, Hkv, hd, False, "float32")
    jx, tx = _x(rng, (B, 7, d))
    jk, tk = _x(rng, (B, 11, Hkv, hd))
    jv, tv = _x(rng, (B, 11, Hkv, hd))
    kw = dict(n_heads=H, n_kv=Hkv, head_dim=hd, rope="none")
    want, jnew = JL.attention_apply(jp, jx, cross_kv=(jk, jv), **kw)
    got, tnew = L.attention_apply(tp, tx, cross_kv=(tk, tv), **kw)
    assert jnew is None and tnew is None
    assert _rel(got, want) <= 2e-6


@pytest.mark.parametrize("causal", [True, False])
def test_online_and_direct_attention_agree(rng, causal):
    """The two paths of the port compute the same function (the JAX
    package switches between them at S = 4)."""
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 50, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 50, 2, 8)).astype(np.float32))
    kw = dict(causal=causal, q_offset=10, kv_len=45)
    a = L._online_attn(q, k, v, q_block=16, kv_block=8, **kw)
    b = L._direct_attn(q, k, v, **kw)
    assert _rel(a, b.numpy()) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(rng, act, dtype):
    d, f = 32, 96
    named = {"wi": rng.standard_normal((d, f)) / np.sqrt(d),
             "wo": rng.standard_normal((f, d)) / np.sqrt(f)}
    if act == "swiglu":
        named["wg"] = rng.standard_normal((d, f)) / np.sqrt(d)
    else:
        named["bi"] = 0.1 * rng.standard_normal(f)
        named["bo"] = 0.1 * rng.standard_normal(d)
    jp, tp = _both(named, dtype)
    jx, tx = _x(rng, (2, 5, d), dtype)
    got = L.mlp_apply(tp, tx, act=act)
    assert got.dtype == tx.dtype
    assert _rel(got.float(), JL.mlp_apply(jp, jx, act=act)) <= TOL[dtype]
    init = L.mlp_init(torch.Generator().manual_seed(0), d, f, act=act)
    assert set(init) == set(named)


@pytest.mark.parametrize("tied", [True, False])
def test_embedding_and_lm_head(rng, tied):
    V, d = 64, 16
    je, te = _both({"table": 0.02 * rng.standard_normal((V, d))})
    jh, th = _both({"w": rng.standard_normal((d, V)) / 4.0})
    tokens = rng.integers(0, V, (2, 5)).astype(np.int32)
    jx = JL.embed_apply(je, jnp.asarray(tokens))
    tx = L.embed_apply(te, torch.from_numpy(tokens))
    assert _rel(tx, jx) == 0.0
    want = JL.lm_head_apply(je, jx, None if tied else jh)
    got = L.lm_head_apply(te, tx, None if tied else th)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 2e-6
    table = L.embed_init(torch.Generator().manual_seed(0), V, d)["table"]
    assert table.shape == (V, d) and table.dtype == torch.bfloat16

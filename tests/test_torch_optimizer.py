"""The port's optimizers (``repro_torch.train.optimizer``): the
counterparts of ``tests/test_train.py``'s optimizer cases, and each
function against the JAX package's on the same numpy inputs.

Tolerances against the JAX package (float32): the schedule to 1 ulp of
float32 (2e-7 relative; ``cos`` of two libraries); the global norm to
2e-6 relative (a sum of squares in another order); an AdamW or Adafactor
step to 1e-6 of the largest parameter (one step's float32 arithmetic in
another evaluation order); int8 quantization exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.train import optimizer as OPT

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as JOPT  # noqa: E402


class TestOptimizers:
    @pytest.mark.parametrize("kind", ["adamw", "adafactor"])
    def test_descends_quadratic(self, kind):
        opt = OPT.make_optimizer(kind)
        params = [torch.tensor([5.0, -3.0, 2.0])]
        state = opt.init(params)
        for _ in range(200):
            grads = [2 * params[0]]
            params, state = opt.update(grads, state, params, 0.05)
        assert float(params[0].abs().max()) < 0.5

    def test_adamw_matrix_decay_only(self):
        params = [torch.ones((4, 4)), torch.ones((4,))]
        state = OPT.adamw_init(params)
        g = [torch.zeros((4, 4)), torch.zeros((4,))]
        p2, _ = OPT.adamw_update(g, state, params, 0.1, weight_decay=0.5)
        assert float(p2[0][0, 0]) < 1.0      # decayed
        assert float(p2[1][0]) == 1.0        # not decayed

    def test_adamw_state_is_float32_beside_bf16_params(self):
        """The moments stay float32 and the update is formed in float32,
        then rounded once to the parameter's dtype."""
        p = torch.full((8, 8), 1.0, dtype=torch.bfloat16)
        state = OPT.adamw_init([p])
        assert state["m"][0].dtype == state["v"][0].dtype == torch.float32
        assert state["count"].dtype == torch.int32
        g = torch.full((8, 8), 1e-3, dtype=torch.bfloat16)
        want = (p.float() - 1e-3 * (1.0 + 0.1 * p.float())).to(torch.bfloat16)
        (p2,), st = OPT.adamw_update([g], state, [p], 1e-3)
        assert p2.dtype == torch.bfloat16 and int(st["count"]) == 1
        assert torch.equal(p2, want)

    def test_clip_global_norm(self):
        g = [torch.full((10,), 100.0)]
        clipped, norm = OPT.clip_by_global_norm(g, 1.0)
        total = float(torch.sqrt(torch.sum(clipped[0] ** 2)))
        assert abs(total - 1.0) < 1e-5
        assert abs(float(norm) - 100.0 * np.sqrt(10)) < 1e-3

    def test_warmup_cosine(self):
        lr = OPT.warmup_cosine(1.0, 10, 100)
        assert lr(0) == 0.0
        assert abs(lr(10) - 1.0) < 0.11
        assert lr(100) < lr(50)

    def test_int8_roundtrip_error(self, rng):
        x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
        q, s = OPT.quantize_int8(x)
        assert q.dtype == torch.int8
        xr = OPT.dequantize_int8(q, s)
        rel = float((xr - x).abs().max() / x.abs().max())
        assert rel < 1.0 / 127 + 1e-3

    def test_unknown_optimizer_raises(self):
        with pytest.raises(ValueError):
            OPT.make_optimizer("sgd")


# ---------------------------------------------------- against the JAX package
SHAPES = [(6, 5), (7,), (3, 4, 5), (2, 9)]


def _inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(dtype) for s in SHAPES]
    grads = [(0.1 * rng.standard_normal(s)).astype(dtype) for s in SHAPES]
    return params, grads


def _jtree(arrays):
    return {f"p{i}": jnp.asarray(a) for i, a in enumerate(arrays)}


def _torch(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("step", [0, 5, 10, 57, 100, 130])
def test_warmup_cosine_matches_jax(step):
    got = OPT.warmup_cosine(3e-4, 10, 100)(step)
    want = float(JOPT.warmup_cosine(3e-4, 10, 100)(step))
    assert got == pytest.approx(want, rel=2e-7, abs=0.0)


def test_clip_by_global_norm_matches_jax():
    _, grads = _inputs(0)
    big = [10.0 * g for g in grads]
    clipped, norm = OPT.clip_by_global_norm(_torch(big), 1.0)
    jclipped, jnorm = JOPT.clip_by_global_norm(_jtree(big), 1.0)
    assert _rel(float(norm), float(jnorm)) <= 2e-6
    for i, c in enumerate(clipped):
        assert _rel(c.numpy(), jclipped[f"p{i}"]) <= 2e-6


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_jax(steps):
    params, grads = _inputs(1)
    tp, jp = _torch(params), _jtree(params)
    ts, js = OPT.adamw_init(tp), JOPT.adamw_init(jp)
    for k in range(steps):
        g = [(1.0 + k) * x for x in grads]
        tp, ts = OPT.adamw_update(_torch(g), ts, tp, 1e-2)
        jp, js = JOPT.adamw_update(_jtree(g), js, jp, 1e-2)
    assert int(ts["count"]) == int(js["count"]) == steps
    for i in range(len(SHAPES)):
        assert _rel(tp[i].numpy(), jp[f"p{i}"]) <= 1e-6
        assert _rel(ts["m"][i].numpy(), js["m"][f"p{i}"]) <= 1e-6
        assert _rel(ts["v"][i].numpy(), js["v"][f"p{i}"]) <= 1e-6


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adafactor_matches_jax(weight_decay):
    params, grads = _inputs(2)
    tp, jp = _torch(params), _jtree(params)
    ts, js = OPT.adafactor_init(tp), JOPT.adafactor_init(jp)
    for i, s in enumerate(SHAPES):
        want = set(js["slots"][f"p{i}"])
        assert set(ts["slots"][i]) == want
        for name in want:
            assert tuple(ts["slots"][i][name].shape) == \
                js["slots"][f"p{i}"][name].shape
    for k in range(2):
        g = [(1.0 + k) * x for x in grads]
        tp, ts = OPT.adafactor_update(_torch(g), ts, tp, 1e-2,
                                      weight_decay=weight_decay)
        jp, js = JOPT.adafactor_update(_jtree(g), js, jp, 1e-2,
                                       weight_decay=weight_decay)
    for i in range(len(SHAPES)):
        assert _rel(tp[i].numpy(), jp[f"p{i}"]) <= 1e-6
        for name, v in ts["slots"][i].items():
            assert _rel(v.numpy(), js["slots"][f"p{i}"][name]) <= 1e-6


def test_adamw_bf16_params_match_jax():
    """bfloat16 parameters and gradients: the float32 moments and the
    update rounded to bfloat16 agree with the JAX package's (at most one
    bfloat16 ulp apart, where the float32 results straddle a rounding
    boundary)."""
    params, grads = _inputs(3)
    tp = [torch.from_numpy(p).to(torch.bfloat16) for p in params]
    tg = [torch.from_numpy(g).to(torch.bfloat16) for g in grads]
    jp = {f"p{i}": jnp.asarray(p.float().numpy()).astype(jnp.bfloat16)
          for i, p in enumerate(tp)}
    jg = {f"p{i}": jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
          for i, g in enumerate(tg)}
    tp, ts = OPT.adamw_update(tg, OPT.adamw_init(tp), tp, 1e-2)
    jp, js = JOPT.adamw_update(jg, JOPT.adamw_init(jp), jp, 1e-2)
    for i in range(len(SHAPES)):
        assert tp[i].dtype == torch.bfloat16
        want = np.asarray(jp[f"p{i}"]).astype(np.float32)
        ulp = np.abs(want) * 2.0 ** -7
        assert np.all(np.abs(tp[i].float().numpy() - want) <= ulp)
        assert _rel(ts["m"][i].numpy(), js["m"][f"p{i}"]) <= 1e-6


def test_quantize_int8_matches_jax(rng):
    x = rng.standard_normal((33, 7)).astype(np.float32)
    q, s = OPT.quantize_int8(torch.from_numpy(x))
    jq, js = JOPT.quantize_int8(jnp.asarray(x))
    assert float(s) == pytest.approx(float(js), rel=1e-7)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(
        OPT.dequantize_int8(q, s).numpy(),
        np.asarray(JOPT.dequantize_int8(jq, js)), rtol=1e-6)

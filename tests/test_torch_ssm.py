"""Parity of the port's Mamba mixer (``repro_torch.models.ssm``) and the
plain selective scan (``kernels.ref.mamba_scan_ref``, kernel B6's plain
version) with the JAX package's.

The same numpy weights and inputs, made from a seed, go through both.  The
JAX ``"pallas"`` scan runs as ``tests/test_mamba_kernel.py`` runs it on
the CPU, in interpret mode; the port's ``"kernel"`` scan runs the plain
version there (CPU tensors).  Tolerances, as max |port - JAX| over
max |JAX|: float32 2e-6 for the scan alone and 1e-6 for the mixer and its
decode step (both take the exponentials and the state sums in other
orders; the largest seen are 3.6e-7 and 2.3e-7); bfloat16 mixers 2^-7,
one unit of the output's last place, because the two frameworks may round
a float32 value on opposite sides (none differs in these cases).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba_scan import mamba_scan_pallas  # noqa: E402
from repro.kernels.ref import mamba_scan_ref as jax_scan_ref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.interop import tensor_from_array  # noqa: E402
from repro_torch.kernels.ref import mamba_scan_ref  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.layers import params  # noqa: E402

ml_dtypes = pytest.importorskip("ml_dtypes")

NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MIXER_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
#: the port's scan impls and the JAX package's names for them
IMPLS = {"materialized": "materialized", "chunked": "chunked",
         "kernel": "pallas"}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale else 1.0))


def _scan_inputs(rng, B, S_, di, N):
    """As ``tests/test_mamba_kernel.py`` makes them."""
    return (np.abs(rng.standard_normal((B, S_, di))).astype(np.float32) * 0.1,
            rng.standard_normal((B, S_, di)).astype(np.float32),
            rng.standard_normal((B, S_, N)).astype(np.float32),
            rng.standard_normal((B, S_, N)).astype(np.float32),
            -np.abs(rng.standard_normal((di, N))).astype(np.float32))


@pytest.mark.parametrize("B,S_,di,N", [
    (1, 16, 8, 2), (2, 64, 32, 4), (1, 128, 64, 8), (3, 32, 16, 16),
])
def test_scan_ref_matches_jax_ref_and_pallas(rng, B, S_, di, N):
    args = _scan_inputs(rng, B, S_, di, N)
    got = mamba_scan_ref(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in args]
    assert _rel(got, jax_scan_ref(*jargs)) <= 2e-6
    pallas = mamba_scan_pallas(*jargs, d_tile=min(di, 16), s_blk=16,
                               interpret=True)
    assert _rel(got, pallas) <= 2e-6


def test_scan_ref_keeps_its_dtype(rng):
    args = _scan_inputs(rng, 2, 20, 6, 3)
    y64 = mamba_scan_ref(*(torch.from_numpy(a).double() for a in args))
    y32 = mamba_scan_ref(*(torch.from_numpy(a) for a in args))
    assert y64.dtype == torch.float64
    assert _rel(y32, y64.numpy()) <= 2e-6


def test_softplus_matches_jax_beyond_torch_threshold():
    x = np.array([-40.0, -5.0, 0.0, 3.0, 19.9, 20.5, 35.0, 90.0],
                 np.float32)
    got = S._softplus(torch.from_numpy(x))
    assert _rel(got, jax.nn.softplus(jnp.asarray(x))) <= 1e-7


def _weights(rng, d_model, cfg, dtype):
    """numpy weights of one Mamba mixer, laid out as ``mamba_init``."""
    di, dr, N = cfg.inner(d_model), cfg.rank(d_model), cfg.d_state
    K = cfg.d_conv
    w = {"in_proj": rng.standard_normal((d_model, 2 * di)) / np.sqrt(d_model),
         "conv_w": rng.standard_normal((K, di)) / np.sqrt(K),
         "conv_b": 0.1 * rng.standard_normal(di),
         "x_proj": rng.standard_normal((di, dr + 2 * N)) / np.sqrt(di),
         "dt_proj": rng.standard_normal((dr, di)) / np.sqrt(dr),
         "out_proj": rng.standard_normal((di, d_model)) / np.sqrt(di)}
    w = {k: v.astype(NP[dtype]) for k, v in w.items()}
    w["dt_bias"] = np.full(di, -4.6, np.float32) + 0.5 * rng.standard_normal(
        di).astype(np.float32)
    w["A_log"] = np.log(np.arange(1, N + 1, dtype=np.float32)
                        * np.exp(0.3 * rng.standard_normal((di, N)))
                        ).astype(np.float32)
    w["D"] = (1.0 + 0.1 * rng.standard_normal(di)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in w.items()},
            params(**{k: tensor_from_array(v, "cpu") for k, v in w.items()}))


def _cfgs(impl, N=4):
    return (JS.SSMConfig(d_state=N, d_conv=4, expand=2,
                         scan_impl=IMPLS[impl]),
            S.SSMConfig(d_state=N, d_conv=4, expand=2, scan_impl=impl))


def test_init_matches_jax_layout():
    cfg = S.SSMConfig(d_state=4)
    p = S.mamba_init(torch.Generator().manual_seed(0), 16, cfg, torch.float32)
    jp = JS.mamba_init(jax.random.PRNGKey(0), 16, JS.SSMConfig(d_state=4),
                       jnp.float32)
    assert set(p) == set(jp)
    for k in p:
        assert tuple(p[k].shape) == tuple(jp[k].shape), k
        assert str(p[k].dtype).split(".")[-1] == jp[k].dtype.name, k
    torch.testing.assert_close(p["A_log"], torch.from_numpy(
        np.array(jp["A_log"])))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", list(IMPLS))
def test_mamba_apply_matches_jax(rng, impl, dtype):
    """Each port impl against the JAX impl of the same name, at a length
    (40) that is not a multiple of the chunk (16), so the JAX code pads."""
    d_model = 16
    jcfg, tcfg = _cfgs(impl)
    jp, tp = _weights(rng, d_model, tcfg, dtype)
    x = (rng.standard_normal((2, 40, d_model))).astype(NP[dtype])
    want = JS.mamba_apply(jp, jnp.asarray(x), jcfg, chunk=16)
    got = S.mamba_apply(tp, tensor_from_array(x, "cpu"), tcfg, chunk=16)
    assert got.dtype == TDT[dtype] and got.shape == (2, 40, d_model)
    assert _rel(got.float(), want) <= MIXER_TOL[dtype]


def test_the_port_impls_agree(rng):
    d_model = 16
    _, tcfg = _cfgs("materialized")
    _, tp = _weights(rng, d_model, tcfg, "float32")
    x = torch.from_numpy(rng.standard_normal((2, 33, d_model)).astype(
        np.float32))
    y0 = S.mamba_apply(tp, x, tcfg, chunk=8)
    for impl in ("chunked", "kernel"):
        yi = S.mamba_apply(tp, x, dataclasses.replace(tcfg, scan_impl=impl),
                           chunk=8)
        assert _rel(yi, y0.numpy()) <= 1e-6, impl
    with pytest.raises(ValueError, match="scan_impl"):
        S.mamba_apply(tp, x, dataclasses.replace(tcfg, scan_impl="pallas"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(rng, dtype):
    d_model, B, steps = 16, 2, 6
    jcfg, tcfg = _cfgs("materialized")
    jp, tp = _weights(rng, d_model, tcfg, dtype)
    js = JS.mamba_decode_init(B, d_model, jcfg, JDT[dtype])
    ts = S.mamba_decode_init(B, d_model, tcfg, TDT[dtype], "cpu")
    assert ts["ssm"].dtype == torch.float32
    for _ in range(steps):
        x = rng.standard_normal((B, 1, d_model)).astype(NP[dtype])
        jo, js = JS.mamba_decode_step(jp, jnp.asarray(x), js, jcfg)
        to, ts = S.mamba_decode_step(tp, tensor_from_array(x, "cpu"), ts,
                                     tcfg)
        assert to.dtype == TDT[dtype]
        assert _rel(to.float(), jo) <= MIXER_TOL[dtype]
    assert _rel(ts["ssm"], js["ssm"]) <= MIXER_TOL[dtype]
    assert _rel(ts["conv"].float(), js["conv"]) <= MIXER_TOL[dtype]


@pytest.mark.parametrize("impl", list(IMPLS))
def test_decode_matches_apply(rng, impl):
    """Token-by-token decode equals the whole-sequence mixer (float32)."""
    d_model, B, S_ = 16, 2, 12
    _, tcfg = _cfgs(impl)
    _, tp = _weights(rng, d_model, tcfg, "float32")
    x = torch.from_numpy(rng.standard_normal((B, S_, d_model)).astype(
        np.float32))
    y = S.mamba_apply(tp, x, tcfg, chunk=8)
    st = S.mamba_decode_init(B, d_model, tcfg, torch.float32, "cpu")
    outs = []
    for t in range(S_):
        o, st = S.mamba_decode_step(tp, x[:, t:t + 1], st, tcfg)
        outs.append(o)
    assert _rel(torch.cat(outs, dim=1), y.numpy()) <= 1e-6

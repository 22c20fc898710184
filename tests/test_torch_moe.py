"""Parity of the port's MoE layer (``repro_torch.models.moe``) with the JAX
package's (``repro.models.moe``), for both dispatches.

The same numpy weights and tokens, made from a seed, go through both, in
float32.  The router logits are sharpened (router weights times 20, as
``tests/test_models_smoke.py`` does for its parity test), so that
``lax.top_k`` and ``torch.topk``, which may break near-ties differently,
pick the same experts.  Tolerance: max |port - JAX| over max |JAX| 2e-6
(the same float32 products summed in other orders; the largest seen is
2.4e-7); the load-balancing loss 1e-6 relative.  A capacity of 1.0 drops
tokens; both packages must drop the same ones (stable sort by expert).

A batch split into blocks of rows (a trainer's ranks) with
``rows=RowShare(...)`` gives, block by block, the JAX package's output of
the whole batch: the same capacity, the same dropped tokens, the same
load-balancing loss.  The ranks' gather is played here in one process:
a first pass records each block's statistics, a second returns them all.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.layers import params  # noqa: E402

TOL = 2e-6


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale else 1.0))


def _weights(rng, d, f, E, act):
    w = {"router": 20.0 * rng.standard_normal((d, E)) / np.sqrt(d),
         "wi": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "wo": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    if act == "swiglu":
        w["wg"] = rng.standard_normal((E, d, f)) / np.sqrt(d)
    w = {k: v.astype(np.float32) for k, v in w.items()}
    return ({k: jnp.asarray(v) for k, v in w.items()},
            params(**{k: torch.from_numpy(v) for k, v in w.items()}))


CASES = [
    # (ghost, act, n_experts, top_k, capacity_factor)
    (True, "swiglu", 4, 2, 1.25),
    (False, "swiglu", 4, 2, 1.25),
    (True, "gelu", 8, 1, 1.25),
    (False, "gelu", 8, 1, 1.25),
    (True, "swiglu", 4, 2, 1.0),     # tight capacity: tokens are dropped
    (False, "swiglu", 4, 2, 1.0),
    (True, "swiglu", 4, 2, 8.0),
]


@pytest.mark.parametrize("ghost,act,E,K,cf", CASES)
def test_moe_apply_matches_jax(rng, ghost, act, E, K, cf):
    d, f, B, S = 16, 32, 2, 12
    jp, tp = _weights(rng, d, f, E, act)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    jcfg = JM.MoEConfig(n_experts=E, top_k=K, capacity_factor=cf,
                        ghost_dispatch=ghost)
    tcfg = M.MoEConfig(n_experts=E, top_k=K, capacity_factor=cf,
                       ghost_dispatch=ghost)
    want, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg, act=act)
    got, taux = M.moe_apply(tp, torch.from_numpy(x), tcfg, act=act)
    assert got.dtype == torch.float32 and got.shape == (B, S, d)
    assert _rel(got, want) <= TOL
    assert abs(float(taux["load_balance"]) - float(jaux["load_balance"])) \
        <= 1e-6 * abs(float(jaux["load_balance"]))


def test_the_dispatches_agree_with_each_other(rng):
    d, f, E = 16, 32, 4
    _, tp = _weights(rng, d, f, E, "swiglu")
    x = torch.from_numpy(rng.standard_normal((3, 10, d)).astype(np.float32))
    cfg = M.MoEConfig(n_experts=E, top_k=2, capacity_factor=1.0)
    a, _ = M.moe_apply(tp, x, cfg)
    b, _ = M.moe_apply(tp, x, dataclasses.replace(cfg, ghost_dispatch=False))
    assert _rel(a, b.numpy()) <= 1e-6


def test_router_jitter_needs_a_generator(rng):
    d, f, E = 16, 32, 4
    _, tp = _weights(rng, d, f, E, "swiglu")
    x = torch.from_numpy(rng.standard_normal((1, 6, d)).astype(np.float32))
    cfg = M.MoEConfig(n_experts=E, top_k=2, router_jitter=0.5)
    plain, _ = M.moe_apply(tp, x, dataclasses.replace(cfg, router_jitter=0.0))
    same, _ = M.moe_apply(tp, x, cfg)                 # no generator: no jitter
    torch.testing.assert_close(same, plain, rtol=0, atol=0)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    torch.testing.assert_close(M.moe_apply(tp, x, cfg, generator=g1)[0],
                               M.moe_apply(tp, x, cfg, generator=g2)[0],
                               rtol=0, atol=0)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_init_matches_jax_layout(act):
    cfg = M.MoEConfig(n_experts=4, top_k=2)
    p = M.moe_init(torch.Generator().manual_seed(0), 16, 32, cfg, act=act)
    jp = JM.moe_init(jax.random.PRNGKey(0), 16, 32,
                     JM.MoEConfig(n_experts=4, top_k=2), act=act)
    assert set(p) == set(jp)
    for k in p:
        assert tuple(p[k].shape) == tuple(jp[k].shape), k
    assert p["router"].dtype == torch.float32
    assert p["wi"].dtype == torch.bfloat16


def _split_apply(tp, x, cfg, n, act):
    """``x``'s rows in ``n`` blocks, each through ``moe_apply`` as rank
    ``r`` of ``n`` (``RowShare``); returns the outputs stacked back and
    each block's load-balancing loss."""
    b = x.shape[0] // n
    seen = [None] * n

    def run(r, gather):
        return M.moe_apply(tp, x[r * b:(r + 1) * b], cfg, act=act,
                           rows=M.RowShare(gather=gather, index=r))

    for r in range(n):                  # the statistics of every block
        def record(t, r=r):
            seen[r] = t.clone()
            return t[None].repeat((n,) + (1,) * t.ndim)
        run(r, record)
    outs = [run(r, lambda t: torch.stack(seen)) for r in range(n)]
    return (torch.cat([o for o, _ in outs]),
            [float(a["load_balance"]) for _, a in outs])


@pytest.mark.parametrize("ghost", [True, False])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cf", [1.0, 1.25])
def test_split_rows_dispatch_as_the_whole_batch(rng, ghost, n, cf):
    """Blocks of rows with ``rows`` give the JAX output of the whole
    batch (tokens are dropped at this capacity: the capacity factor 8
    output differs); blocks dispatched each on their own do not."""
    d, f, E, K, B, S = 16, 32, 4, 2, 4, 12
    jp, tp = _weights(rng, d, f, E, "swiglu")
    # a direction shared by every token loads some experts more
    x = (rng.standard_normal((B, S, d))
         + rng.standard_normal(d)).astype(np.float32)
    jcfg = JM.MoEConfig(n_experts=E, top_k=K, capacity_factor=cf,
                        ghost_dispatch=ghost)
    tcfg = M.MoEConfig(n_experts=E, top_k=K, capacity_factor=cf,
                       ghost_dispatch=ghost)
    want, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    ample, _ = JM.moe_apply(jp, jnp.asarray(x),
                            dataclasses.replace(jcfg, capacity_factor=8.0))
    assert _rel(ample, want) > 1e-2             # the capacity drops tokens
    got, aux = _split_apply(tp, torch.from_numpy(x), tcfg, n, "swiglu")
    assert _rel(got, want) <= TOL
    lb = float(jaux["load_balance"])
    assert all(abs(a - lb) <= 1e-6 * abs(lb) for a in aux)
    b = B // n
    alone = torch.cat([M.moe_apply(tp, torch.from_numpy(x[r * b:(r + 1) * b]),
                                   tcfg)[0] for r in range(n)])
    assert _rel(alone, want) > 1e-2

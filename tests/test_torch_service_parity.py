"""Parity of the port's SolverService with the JAX package's.

The same scenarios (numpy right-hand sides from a seed) run through the
JAX ``ServiceHarness`` (``tests/service_harness.py``) and the port's
(``tests/torch_service_harness.py``), both on a virtual clock, and are
compared per ticket: ``status``, ``key``, ``pred_iters``,
``result.iters``, ``result.converged``, ``latency`` and ``queue_wait``,
plus the service's ``stats``.

The registry's Lanczos start vector comes from ``jax.random`` in the
reference and from a ``torch.Generator`` in the port, so the port's
registry is handed the JAX registry's Ritz values before the first
submit; difficulty buckets and Chebyshev intervals then agree.

Tolerances: in float64 (the JAX side under ``jax.enable_x64``) every
compared field is exact and ``x`` agrees within 1e-9 of ``max|x|``, the
bound ``test_torch_cg.py`` and ``test_torch_precond.py`` use.  In
float32, and with bfloat16 storage, the two frameworks sum in different
orders.  Statuses, keys, stats and iteration counts are still exact on
these scenarios (``F32_ITERS = 0``); ``x`` agrees within ``F32_X`` of
``max|x|`` (observed 4e-6: float32 roundoff amplified over the few
hundred iterations of these solves).
"""
import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference package needs JAX
import jax.numpy as jnp  # noqa: E402

from repro.matrices import anisotropic_laplace2d, laplace3d  # noqa: E402
from repro.runtime import MatrixRegistry as JRegistry  # noqa: E402
from repro_torch.runtime import MatrixRegistry  # noqa: E402
from service_harness import ServiceHarness as JHarness  # noqa: E402
from torch_service_harness import ServiceHarness, assert_consistent  # noqa: E402

F32_ITERS = 0
F32_X = 1e-4
F64_X = 1e-9

#: matrices of the scenarios: name -> (generator, args, build kwargs)
MATS = {
    "lap": (laplace3d, (6,), dict(C=16, sigma=32, w_align=4)),
    "easy": (laplace3d, (5,), dict(C=8, sigma=16, w_align=4)),
    "hard": (anisotropic_laplace2d, (16,),
             dict(C=16, sigma=1, w_align=4, epsilon=1e-2)),
    "ani": (anisotropic_laplace2d, (24,),
            dict(C=16, sigma=1, w_align=4, epsilon=1e-2)),
}


def _coo(name):
    gen, args, kw = MATS[name]
    kw = dict(kw)
    extra = {"epsilon": kw.pop("epsilon")} if "epsilon" in kw else {}
    return gen(*args, **extra), kw


def _registries(names, dtype, bf16):
    """The JAX and the port registry over the same COO data, the port's
    holding the JAX registry's Ritz values."""
    jreg, treg = JRegistry(), MatrixRegistry()
    for name in names:
        (r, c, v, n), kw = _coo(name)
        jreg.register(name, rows=r, cols=c, vals=v, shape=(n, n),
                      dtype=dtype, store_dtype=jnp.bfloat16 if bf16 else None,
                      **kw)
        treg.register(name, rows=r, cols=c, vals=v, shape=(n, n),
                      dtype=dtype, store_dtype=torch.bfloat16 if bf16 else None,
                      device="cpu", **kw)
        treg.entry(name).ritz = np.array(jreg._lanczos_ritz(name))
    return jreg, treg


def _rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


# ---------------------------------------------------------------- scenarios
def fifo_mixed(h, n, dt):
    """Mixed solvers and tolerances through FIFO batches with refills."""
    solvers = ["cg", "cg", "minres", "pipelined_cg"]
    tols = [1e-4, 1e-6, 1e-7]
    if dt == np.float32:
        tols = [1e-3, 1e-4, 1e-5]          # pipelined CG stalls below
    ts = [h.submit("lap", _rhs(n["lap"], i).astype(dt),
                   solver=solvers[i % 4], tol=tols[i % 3], maxiter=500)
          for i in range(12)]
    h.drain()
    return ts


def bucketed_stragglers(h, n, dt):
    """Stragglers first, then easy work: bucketed keys, the dispatcher,
    aging and adaptive width."""
    ts = [h.submit("hard", _rhs(n["hard"], i).astype(dt), tol=1e-10,
                   maxiter=300) for i in range(3)]
    ts += [h.submit("easy", _rhs(n["easy"], 10 + i).astype(dt), tol=1e-4,
                    maxiter=300, priority=i % 2) for i in range(8)]
    h.drain()
    return ts


def deadlines(h, n, dt):
    """Expiry while running (at retire, best-effort x), while queued (at
    refill), and a deadline that shrinks chunks (``iter_time_hint``)."""
    ts = [h.submit("lap", _rhs(n["lap"], 0).astype(dt), tol=1e-30,
                   maxiter=10 ** 6, deadline=5.0),
          h.submit("lap", _rhs(n["lap"], 1).astype(dt), tol=1e-6)]
    h.step()
    ts += [h.submit("lap", _rhs(n["lap"], 2).astype(dt), tol=1e-6,
                    deadline=1.0),
           h.submit("lap", _rhs(n["lap"], 3).astype(dt), tol=1e-5,
                    deadline=40.0),
           h.submit("lap", _rhs(n["lap"], 4).astype(dt), tol=1e-5,
                    block=True, deadline=2.0),
           h.submit("lap", _rhs(n["lap"], 5).astype(dt), tol=1e-30,
                    maxiter=10 ** 6, block=True, deadline=6.0)]
    h.drain()
    return ts


def cancels(h, n, dt):
    """Cancel while queued (instant) and while running (next boundary)."""
    ts = [h.submit("lap", _rhs(n["lap"], i).astype(dt), tol=1e-10,
                   solver=["cg", "minres"][i % 2]) for i in range(5)]
    ts.append(h.submit("lap", _rhs(n["lap"], 9).astype(dt), tol=1e-6,
                       block=True))
    h.step()
    h.cancel(ts[4])                     # queued
    h.cancel(ts[0])                     # running
    h.step()
    h.cancel(ts[5])                     # running block column
    h.drain()
    return ts


def rejections(h, n, dt):
    """``max_queue`` rejection, per key, and recovery after a drain."""
    ts = [h.submit("lap", _rhs(n["lap"], i).astype(dt), tol=1e-5)
          for i in range(5)]
    ts.append(h.submit("lap", _rhs(n["lap"], 7).astype(dt), tol=1e-5,
                       solver="minres"))
    h.drain()
    ts.append(h.submit("lap", _rhs(n["lap"], 8).astype(dt), tol=1e-5))
    h.drain()
    return ts


def block_restart(h, n, dt):
    """Block batches: warm restarts with adaptive width, CG and MINRES."""
    ts = [h.submit("lap", _rhs(n["lap"], i).astype(dt), tol=1e-6,
                   block=True, solver=["cg", "minres"][i // 4])
          for i in range(8)]
    h.step()
    h.run_until(lambda: ts[0].resolved)
    ts += [h.submit("lap", _rhs(n["lap"], 20 + i).astype(dt), tol=1e-5,
                    block=True) for i in range(3)]
    h.drain()
    return ts


def preconditioned(h, n, dt):
    """Plain, block-Jacobi and Chebyshev requests on one matrix."""
    specs = [None, "block_jacobi:24", "chebyshev:4"]
    ts = [h.submit("ani", _rhs(n["ani"], i).astype(dt), tol=1e-6,
                   maxiter=2000, precond=specs[i % 3],
                   solver="minres" if i == 4 else "cg")
          for i in range(9)]
    h.drain()
    return ts


#: (scenario, matrices, harness kwargs)
SCENARIOS = {
    "fifo_mixed": (fifo_mixed, ["lap"], dict(block_width=4, chunk_iters=8)),
    "bucketed_stragglers": (bucketed_stragglers, ["easy", "hard"],
                            dict(block_width=4, chunk_iters=8,
                                 admission="bucketed", bucket_base=2.0,
                                 starvation_limit=3)),
    "deadlines": (deadlines, ["lap"],
                  dict(block_width=2, chunk_iters=8,
                       iter_time_hint=lambda key: 1.0)),
    "cancels": (cancels, ["lap"], dict(block_width=2, chunk_iters=4)),
    "rejections": (rejections, ["lap"],
                   dict(block_width=1, chunk_iters=4, max_queue=2)),
    "block_restart": (block_restart, ["lap"],
                      dict(block_width=4, chunk_iters=8,
                           admission="bucketed")),
    "preconditioned": (preconditioned, ["ani"],
                       dict(block_width=3, chunk_iters=8)),
}


def _run_both(name, dtype, bf16=False):
    scenario, mats, kw = SCENARIOS[name]
    x64 = dtype == np.float64
    ctx = jax.enable_x64(True) if x64 else contextlib.nullcontext()
    n = {m: _coo(m)[0][3] for m in mats}
    with ctx:
        jreg, treg = _registries(mats, dtype, bf16)
        jh = JHarness(jreg, **kw)
        jts = scenario(jh, n, dtype)
        jx = [None if t.result is None else np.asarray(t.result.x)
              for t in jts]
    th = ServiceHarness(treg, **kw)
    tts = scenario(th, n, dtype)
    assert_consistent(th.service, tts)
    return jh, jts, jx, th, tts


FIELDS = ("status", "key", "pred_iters", "latency", "queue_wait")


def _compare(jh, jts, jx, th, tts, *, iters_slack, x_rel):
    assert th.service.stats == jh.service.stats
    assert len(tts) == len(jts)
    for jt, tt, x in zip(jts, tts, jx):
        for f in FIELDS:
            assert getattr(tt, f) == getattr(jt, f), (f, jt, tt)
        assert (tt.result is None) == (jt.result is None), (jt, tt)
        if jt.result is None:
            continue
        assert tt.result.converged == bool(jt.result.converged), (jt, tt)
        assert abs(tt.result.iters - int(jt.result.iters)) <= iters_slack, \
            (jt, jt.result.iters, tt.result.iters)
        scale = max(np.abs(x).max(), np.finfo(np.float64).tiny)
        err = np.abs(tt.result.x - x).max() / scale
        assert err <= x_rel, (jt, err)
        assert isinstance(tt.result.x, np.ndarray)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_f64_scenarios_equal_the_reference(name):
    jh, jts, jx, th, tts = _run_both(name, np.float64)
    _compare(jh, jts, jx, th, tts, iters_slack=0, x_rel=F64_X)
    # the scenario exercised what it is named for
    stats = th.service.stats
    want = {"fifo_mixed": stats["refills"] > 2,
            "bucketed_stragglers": stats["batches_opened"] >= 2
            and all(t.pred_iters for t in tts),
            "deadlines": stats["expired"] >= 3 and stats["deadline_chunks"],
            "cancels": stats["cancelled"] == 3,
            "rejections": stats["rejected"] >= 2,
            "block_restart": stats["refills"] >= 2,
            "preconditioned": stats["batches_opened"] == 4}[name]
    assert want, stats


@pytest.mark.parametrize("name", ["fifo_mixed", "bucketed_stragglers"])
def test_f32_scenarios_agree_with_the_reference(name):
    jh, jts, jx, th, tts = _run_both(name, np.float32)
    _compare(jh, jts, jx, th, tts, iters_slack=F32_ITERS, x_rel=F32_X)


def test_bf16_storage_agrees_with_the_reference():
    jh, jts, jx, th, tts = _run_both("fifo_mixed", np.float32, bf16=True)
    assert all(t.key[4] == "bfloat16" for t in tts)
    _compare(jh, jts, jx, th, tts, iters_slack=F32_ITERS, x_rel=F32_X)

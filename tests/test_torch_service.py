"""The port's SolverService + MatrixRegistry (``repro_torch.runtime``):
counterparts of ``tests/test_service.py`` on the CPU (``device="cpu"``),
and the deliberate differences from the JAX package, each pinned here:
``register(impl=None)`` runs the plain version on the CPU and kernel B1
on the card, ``register(device=None)`` is the card, keys carry
numpy-style dtype names, a chunk's clock is read after its ``done``
flags reach the host, and a refill uploads only the admitted columns.

The reference's three engine-backed tests have their counterparts in
``tests/test_torch_service_engine.py``; the engine half of the registry's
block-Jacobi refusal is here, beside the same refusal on a matrix-free
operator.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core import execution, from_coo
from repro_torch.matrices import anisotropic_laplace2d, laplace3d, matpde
from repro_torch.runtime import (SOLVERS, TERMINAL_STATES,
                                 HeterogeneousEngine, MatrixRegistry,
                                 ServiceResult, SolverService, SolveTicket)
from repro_torch.solvers import MatrixFreeOperator, cg, kpm_dos_moments
from torch_service_harness import ServiceHarness, VirtualClock

CPU = dict(device="cpu")
#: an engine with one shard on the host (the reference's single-device mesh)
ONE_HOST = dict(devices=["cpu"])


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


@pytest.fixture(scope="module")
def lap():
    r, c, v, n = laplace3d(7)
    Ad = np.zeros((n, n), np.float32)
    Ad[r, c] += v.astype(np.float32)
    return (r, c, v, n), Ad


@pytest.fixture()
def reg(lap):
    (r, c, v, n), _ = lap
    registry = MatrixRegistry()
    registry.register("lap", rows=r, cols=c, vals=v, shape=(n, n), C=16,
                      sigma=32, w_align=4, dtype=np.float32, **CPU)
    return registry


def _rel(Ad, t):
    return (np.abs(Ad @ t.result.x - np.asarray(t.b)).max()
            / np.abs(np.asarray(t.b)).max())


def test_exports():
    assert set(SOLVERS) == {"cg", "pipelined_cg", "minres"}
    assert TERMINAL_STATES == {"done", "cancelled", "rejected", "expired"}
    assert ServiceResult._fields == ("x", "iters", "resnorm", "converged")
    assert SolveTicket.__name__ == "SolveTicket"


class TestMatrixRegistry:
    def test_build_then_hit(self, lap):
        (r, c, v, n), _ = lap
        registry = MatrixRegistry()
        registry.register("m", rows=r, cols=c, vals=v, shape=(n, n), **CPU)
        registry.register("m", rows=r, cols=c, vals=v, shape=(n, n), **CPU)
        assert registry.stats["builds"] == 1
        assert registry.stats["hits"] == 1
        assert "m" in registry and registry.names() == ["m"]
        assert registry.tuned("m") == {}       # the port tunes nothing

    def test_prebuilt_matrix_and_operator(self, lap):
        (r, c, v, n), _ = lap
        A = from_coo(r, c, v, (n, n), C=16, sigma=32, dtype=np.float32, **CPU)
        registry = MatrixRegistry()
        registry.register("pre", A)
        op = registry.operator("pre")
        assert op.A is A and op.impl is None
        assert registry.entry("pre").nglobal == n
        # an operator-like object registers as-is
        registry.register("op", op)
        assert registry.operator("op") is op
        assert registry.entry("op").nglobal == n

    def test_unknown_matrix_raises(self):
        registry = MatrixRegistry()
        with pytest.raises(KeyError, match="not registered"):
            registry.operator("nope")
        with pytest.raises(ValueError, match="COO triplets"):
            registry.register("partial", rows=[0], cols=[0])

    def test_reregister_different_payload_raises(self, lap):
        (r, c, v, n), _ = lap
        registry = MatrixRegistry()
        registry.register("m", rows=r, cols=c, vals=v, shape=(n, n), **CPU)
        with pytest.raises(ValueError, match="different COO data"):
            registry.register("m", rows=r, cols=c, vals=2.0 * v,
                              shape=(n, n), **CPU)
        v2 = v.copy()
        v2[0], v2[1] = v[1], v[0]
        if not np.array_equal(v2, v):
            with pytest.raises(ValueError, match="different COO data"):
                registry.register("m", rows=r, cols=c, vals=v2, shape=(n, n),
                                  **CPU)
        A = from_coo(r, c, v, (n, n), C=16, dtype=np.float32, **CPU)
        with pytest.raises(ValueError, match="different object"):
            registry.register("m", A)
        registry.register("m")
        assert registry.stats["hits"] == 1

    def test_incomplete_operator_rejected(self):
        class HalfOp:
            def mv(self, x):
                return x

            def mv_fused(self, x, y=None, z=None, opts=None):
                return x, None, None

        registry = MatrixRegistry()
        with pytest.raises(TypeError, match="solver protocol"):
            registry.register("half", HalfOp())

    def test_spectral_bounds_cached(self, reg, lap):
        _, Ad = lap
        lo, hi = reg.spectral_bounds("lap", k=30)
        assert reg.stats["bounds_computed"] == 1
        lo2, hi2 = reg.spectral_bounds("lap", k=30)
        assert (lo, hi) == (lo2, hi2)
        assert reg.stats["bounds_hits"] == 1
        ev = np.linalg.eigvalsh(Ad.astype(np.float64))
        assert lo <= ev[0] + 1e-3 and hi >= ev[-1] - 1e-3


class TestSolverService:
    def test_mixed_tolerance_retire_refill(self, reg, lap):
        (r, c, v, n), Ad = lap
        rng = np.random.default_rng(0)
        h = ServiceHarness(reg, block_width=4, chunk_iters=8)
        svc = h.service
        tols = [1e-4, 1e-6, 1e-7]
        tickets = []
        for i in range(11):
            b = rng.standard_normal(n).astype(np.float32)
            solver = "minres" if i % 4 == 3 else "cg"
            tickets.append(svc.submit("lap", b, solver=solver,
                                      tol=tols[i % 3], maxiter=500))
        h.drain()
        steps = h.clock.now
        assert svc.stats["refills"] > 1
        assert svc.stats["retired"] == 11
        for t in tickets:
            assert t.result.converged, t
            assert isinstance(t.result.x, np.ndarray)
            assert _rel(Ad, t) < 50 * t.tol + 1e-5, t
            assert t.latency == t.finished_at - t.submitted_at
            assert t.latency == int(t.latency) and 0 < t.latency <= steps
        assert min(t.latency for t in tickets) < steps
        assert svc.stats["batches_opened"] == 2

    def test_maxiter_retires_unconverged(self, reg, lap):
        (r, c, v, n), _ = lap
        rng = np.random.default_rng(1)
        svc = SolverService(reg, block_width=2, chunk_iters=4)
        b = rng.standard_normal(n).astype(np.float32)
        t = svc.submit("lap", b, solver="cg", tol=1e-12, maxiter=6)
        svc.drain()
        assert t.done and not t.result.converged
        assert t.result.iters >= 6
        assert svc.pending == 0

    def test_pipelined_cg_kind(self, reg, lap):
        (r, c, v, n), Ad = lap
        rng = np.random.default_rng(2)
        svc = SolverService(reg, block_width=3, chunk_iters=10)
        tickets = [svc.submit("lap",
                              rng.standard_normal(n).astype(np.float32),
                              solver="pipelined_cg", tol=1e-5, maxiter=400)
                   for _ in range(5)]
        svc.drain()
        for t in tickets:
            assert t.result.converged
            assert _rel(Ad, t) < 1e-3
        assert svc.stats["refills"] > 1

    def test_service_matches_direct_solve(self, reg, lap):
        """Block widths differ, so only the convergence guarantee carries
        over (atol 1e-5 at tol 1e-7, the reference test's own margin)."""
        (r, c, v, n), Ad = lap
        rng = np.random.default_rng(3)
        b = rng.standard_normal(n).astype(np.float32)
        svc = SolverService(reg, block_width=2, chunk_iters=16)
        t = svc.submit("lap", b, solver="cg", tol=1e-7, maxiter=500)
        svc.drain()
        op = reg.operator("lap")
        ref = cg(op, op.to_op_space(torch.from_numpy(b)), tol=1e-7,
                 maxiter=500)
        x_ref = op.from_op_space(ref.x).numpy()
        np.testing.assert_allclose(t.result.x, x_ref, atol=1e-5)
        assert t.result.converged and bool(ref.converged)

    def test_bad_requests_raise(self, reg, lap):
        (r, c, v, n), _ = lap
        svc = SolverService(reg)
        with pytest.raises(ValueError, match="unknown solver"):
            svc.submit("lap", np.zeros(n, np.float32), solver="gmres")
        with pytest.raises(KeyError, match="not registered"):
            svc.submit("ghost", np.zeros(n, np.float32))
        with pytest.raises(ValueError, match="block_width"):
            SolverService(reg, block_width=0)
        with pytest.raises(ValueError, match="1-d of length"):
            svc.submit("lap", np.zeros(n + 1, np.float32))
        with pytest.raises(ValueError, match="1-d of length"):
            svc.submit("lap", np.zeros((n, 2), np.float32))
        assert svc.pending == 0

    def test_init_cache_releases_dead_operators(self, lap):
        """The counterpart of the reference's chunk-cache test: the port
        compiles no chunks, but the service's cached batch init must not
        pin the operator — it holds a weakref, and calling it after the
        registry dropped the operator raises ``ReferenceError``."""
        (r, c, v, n), _ = lap
        registry = MatrixRegistry()
        registry.register("m", rows=r, cols=c, vals=v, shape=(n, n), C=16,
                          sigma=32, dtype=np.float32, **CPU)
        svc = SolverService(registry, block_width=2, chunk_iters=8)
        t = svc.submit("m", np.ones(n, np.float32), tol=1e-5)
        svc.drain()
        assert t.result.converged and not svc._batches
        (init,) = svc._init_cache.values()
        ref = weakref.ref(registry.operator("m"))
        del registry._entries["m"]
        gc.collect()
        assert ref() is None
        with pytest.raises(ReferenceError, match="operator evicted"):
            init(torch.zeros(n, 1), torch.ones(1))

    def test_precond_requests_batch_separately(self):
        r, c, v, n = anisotropic_laplace2d(24, epsilon=1e-2)
        Ad = np.zeros((n, n), np.float32)
        Ad[r, c] += v.astype(np.float32)
        registry = MatrixRegistry()
        registry.register("ani", rows=r, cols=c, vals=v, shape=(n, n),
                          C=16, sigma=1, w_align=4, dtype=np.float32, **CPU)
        svc = SolverService(registry, block_width=3, chunk_iters=8)
        rng = np.random.default_rng(4)
        specs = [None, "block_jacobi:24", "chebyshev:4"]
        tickets = {s: [] for s in specs}
        for i in range(12):
            b = rng.standard_normal(n).astype(np.float32)
            s = specs[i % 3]
            tickets[s].append(svc.submit("ani", b, solver="cg", tol=1e-6,
                                         maxiter=2000, precond=s))
        seen_keys = set()
        while svc.pending:
            svc.step()
            seen_keys.update(svc._batches.keys())
        assert {k[3] for k in seen_keys} == {"", "block_jacobi:24",
                                             "chebyshev:4"}
        assert svc.stats["batches_opened"] == 3
        assert svc.stats["refills"] >= 3
        iters = {}
        for s, ts in tickets.items():
            for t in ts:
                assert t.result is not None and t.result.converged, t
                assert _rel(Ad, t) < 1e-4, t
            iters[s] = max(t.result.iters for t in ts)
        assert iters["block_jacobi:24"] * 2 <= iters[None]
        assert iters["chebyshev:4"] * 2 <= iters[None]
        assert registry.stats["precond_builds"] == 2

    def test_precond_registry_caching_and_validation(self, reg, lap):
        (r, c, v, n), _ = lap
        M1 = reg.preconditioner("lap", "block_jacobi:8")
        M2 = reg.preconditioner("lap", "block_jacobi:8")
        assert M1 is M2
        assert reg.stats["precond_builds"] == 1
        assert reg.stats["precond_hits"] == 1
        Mc = reg.preconditioner("lap", "chebyshev")
        assert reg.stats["bounds_computed"] == 1
        assert Mc.degree == 4
        assert reg.preconditioner("lap", "chebyshev:4") is Mc
        svc = SolverService(reg)
        with pytest.raises(ValueError, match="unknown preconditioner"):
            svc.submit("lap", np.zeros(n, np.float32), precond="ilu")
        with pytest.raises(NotImplementedError, match="pipelined_cg"):
            svc.submit("lap", np.zeros(n, np.float32),
                       solver="pipelined_cg", precond="block_jacobi")
        # engine-backed matrices reject block_jacobi with a clear error
        r2, c2, v2, n2 = matpde(12)
        Ad2 = np.zeros((n2, n2)); Ad2[r2, c2] += v2
        spd = (Ad2 @ Ad2.T + n2 * np.eye(n2)).astype(np.float32)
        rs, cs = np.nonzero(spd)
        eng = HeterogeneousEngine(rs, cs, spd[rs, cs], n2, C=8, sigma=1,
                                  w_align=4, dtype=np.float32, **ONE_HOST)
        reg.register("eng", eng)
        with pytest.raises(ValueError, match="block_jacobi"):
            reg.preconditioner("eng", "block_jacobi")

    def test_block_jacobi_refused_without_sellcs(self, lap):
        """The same refusal on a matrix-free operator: it has no stored
        blocks either."""
        (r, c, v, n), Ad = lap
        A = torch.from_numpy(Ad)
        mf = MatrixFreeOperator(lambda x: A @ x, n, torch.float32, **CPU)
        registry = MatrixRegistry()
        registry.register("mf", mf)
        assert registry.entry("mf").store_dtype == "float32"
        with pytest.raises(ValueError, match="not SELL-C-σ backed"):
            registry.preconditioner("mf", "block_jacobi")

    def test_matrix_free_chebyshev_requests(self, lap):
        """The counterpart of the reference's engine Chebyshev test on a
        matrix-free operator: the polynomial apply rides ``mv_fused``."""
        (r, c, v, n), Ad = lap
        A = torch.from_numpy(Ad)
        registry = MatrixRegistry()
        registry.register("mf", MatrixFreeOperator(lambda x: A @ x, n,
                                                   torch.float32, **CPU))
        svc = SolverService(registry, block_width=2, chunk_iters=8)
        rng = np.random.default_rng(12345)
        tickets = [svc.submit("mf",
                              rng.standard_normal(n).astype(np.float32),
                              solver="cg", tol=1e-6, maxiter=400,
                              precond="chebyshev:3")
                   for _ in range(3)]
        svc.drain()
        for t in tickets:
            assert t.result.converged
            assert _rel(Ad, t) < 1e-3

    def test_kpm_uses_cached_bounds(self, reg, lap):
        svc = SolverService(reg)
        mus = svc.kpm_moments("lap", 16, n_probes=2, seed=1)
        assert reg.stats["bounds_computed"] == 1
        op = reg.operator("lap")
        direct = kpm_dos_moments(op, 16, n_probes=2, seed=1,
                                 spectrum=reg.spectral_bounds("lap"))
        np.testing.assert_allclose(mus.numpy(), direct.numpy(), rtol=1e-5,
                                   atol=1e-7)
        assert reg.stats["bounds_hits"] >= 1

    def test_chebfd_uses_cached_bounds(self, lap):
        (r, c, v, n), Ad = lap
        registry = MatrixRegistry()
        registry.register("lap64", rows=r, cols=c, vals=v, shape=(n, n),
                          C=16, sigma=32, dtype=np.float64, **CPU)
        svc = SolverService(registry)
        ev = np.linalg.eigvalsh(Ad.astype(np.float64))
        target = (float(ev[0]) - 1e-3, float(ev[3]) + 1e-3)
        res = svc.chebfd("lap64", target, block_size=8, degree=40, sweeps=4)
        assert registry.stats["bounds_computed"] == 1
        inside = res.eigenvalues[(res.eigenvalues >= target[0])
                                 & (res.eigenvalues <= target[1])]
        assert inside.size >= 1
        assert np.abs(inside[0] - ev[0]) < 1e-6
        assert "admission=fifo" in svc.describe()


class TestBlockKrylovService:
    def test_block_retire_refill_converges(self, reg, lap):
        (r, c, v, n), Ad = lap
        rng = np.random.default_rng(7)
        svc = SolverService(reg, block_width=4, chunk_iters=8)
        tickets = []
        for i in range(11):
            b = rng.standard_normal(n).astype(np.float32)
            solver = "minres" if i % 4 == 3 else "cg"
            tickets.append(svc.submit("lap", b, solver=solver, tol=1e-5,
                                      maxiter=500, block=True))
        seen_keys = set()
        while svc.pending:
            svc.step()
            seen_keys.update(svc._batches.keys())
        assert {k[5] for k in seen_keys} == {"block"}
        assert svc.stats["refills"] > 1
        assert svc.stats["retired"] == 11
        for t in tickets:
            assert t.result.converged, t
            assert t.result.iters <= 500
            assert _rel(Ad, t) < 1e-3, t

    def test_block_and_column_batch_separately(self, reg, lap):
        (r, c, v, n), Ad = lap
        rng = np.random.default_rng(9)
        svc = SolverService(reg, block_width=2, chunk_iters=8)
        tickets = [svc.submit("lap", rng.standard_normal(n).astype(np.float32),
                              solver="cg", tol=1e-5, block=bool(i % 2))
                   for i in range(4)]
        seen_keys = set()
        while svc.pending:
            svc.step()
            seen_keys.update(svc._batches.keys())
        assert {k[5] for k in seen_keys} == {"", "block"}
        assert svc.stats["batches_opened"] == 2
        for t in tickets:
            assert t.result.converged
            assert _rel(Ad, t) < 1e-3

    def test_block_deflation_duplicate_rhs(self, reg, lap):
        (r, c, v, n), Ad = lap
        rng = np.random.default_rng(11)
        b = rng.standard_normal(n).astype(np.float32)
        svc = SolverService(reg, block_width=3, chunk_iters=8)
        t1 = svc.submit("lap", b, solver="cg", tol=1e-5, block=True)
        t2 = svc.submit("lap", b.copy(), solver="cg", tol=1e-5, block=True)
        svc.drain()
        assert t1.result.converged and t2.result.converged
        np.testing.assert_allclose(t1.result.x, t2.result.x, atol=1e-4)
        assert np.abs(Ad @ t1.result.x - b).max() / np.abs(b).max() < 1e-3

    @pytest.mark.parametrize("block", [False, True])
    def test_zero_rhs_converges_immediately(self, reg, lap, block):
        (r, c, v, n), _ = lap
        rng = np.random.default_rng(13)
        svc = SolverService(reg, block_width=2, chunk_iters=4)
        tz = svc.submit("lap", np.zeros(n, np.float32), solver="cg",
                        tol=1e-10, maxiter=50, block=block)
        tb = svc.submit("lap", rng.standard_normal(n).astype(np.float32),
                        solver="cg", tol=1e-5, maxiter=500, block=block)
        svc.drain()
        assert tz.result.converged
        assert np.abs(tz.result.x).max() == 0.0
        assert tz.result.resnorm == 0.0
        assert tb.result.converged

    def test_zero_rhs_pipelined_cg(self, reg, lap):
        (r, c, v, n), _ = lap
        svc = SolverService(reg, block_width=2, chunk_iters=4)
        t = svc.submit("lap", np.zeros(n, np.float32),
                       solver="pipelined_cg", tol=1e-10, maxiter=50)
        svc.drain()
        assert t.result.converged
        assert np.abs(t.result.x).max() == 0.0

    def test_block_validation_at_submit(self, reg, lap):
        (r, c, v, n), _ = lap
        svc = SolverService(reg)
        with pytest.raises(NotImplementedError, match="block=True"):
            svc.submit("lap", np.zeros(n, np.float32),
                       solver="pipelined_cg", block=True)
        with pytest.raises(NotImplementedError, match="preconditioner"):
            svc.submit("lap", np.zeros(n, np.float32), solver="cg",
                       precond="block_jacobi", block=True)
        assert svc.pending == 0


class TestMixedPrecisionService:
    def test_store_dtypes_batch_separately(self, lap):
        (r, c, v, n), Ad = lap
        registry = MatrixRegistry()
        kw = dict(rows=r, cols=c, vals=v, shape=(n, n), C=16, sigma=32,
                  w_align=4, dtype=np.float32, **CPU)
        registry.register("lap_f32", **kw)
        registry.register("lap_bf16", store_dtype=torch.bfloat16, **kw)
        assert registry.entry("lap_f32").store_dtype == "float32"
        assert registry.entry("lap_bf16").store_dtype == "bfloat16"
        svc = SolverService(registry, block_width=3, chunk_iters=8)
        rng = np.random.default_rng(8)
        tickets = []
        for i in range(8):
            b = rng.standard_normal(n).astype(np.float32)
            name = "lap_bf16" if i % 2 else "lap_f32"
            tickets.append(svc.submit(name, b, solver="cg", tol=1e-5,
                                      maxiter=500))
        seen_keys = set()
        while svc.pending:
            svc.step()
            seen_keys.update(svc._batches.keys())
        assert {k[4] for k in seen_keys} == {"float32", "bfloat16"}
        assert svc.stats["batches_opened"] == 2
        for t in tickets:
            assert t.result is not None and t.result.converged, t
            tol = 5e-2 if t.matrix == "lap_bf16" else 1e-3
            assert _rel(Ad, t) < tol, t

    def test_reregister_different_store_dtype_raises(self, lap):
        (r, c, v, n), _ = lap
        registry = MatrixRegistry()
        kw = dict(rows=r, cols=c, vals=v, shape=(n, n), C=16,
                  dtype=np.float32, **CPU)
        registry.register("m", **kw)
        with pytest.raises(ValueError, match="storage dtype"):
            registry.register("m", store_dtype=torch.bfloat16, **kw)
        # spelled as None, as the numpy or the torch compute dtype, or by
        # name: the same resolved storage dtype, a hit each time
        registry.register("m", store_dtype=None, **kw)
        registry.register("m", store_dtype=np.float32, **kw)
        registry.register("m", store_dtype=torch.float32, **kw)
        registry.register("m", store_dtype="float32", **kw)
        assert registry.stats["hits"] == 4

    def test_block_jacobi_on_bf16_storage(self):
        r, c, v, n = anisotropic_laplace2d(24, epsilon=1e-2)
        registry = MatrixRegistry()
        registry.register("ani16", rows=r, cols=c, vals=v, shape=(n, n),
                          C=16, sigma=1, w_align=4, dtype=np.float32,
                          store_dtype=torch.bfloat16, **CPU)
        M = registry.preconditioner("ani16", "block_jacobi:24")
        assert M.inv_blocks.dtype == torch.float32     # compute, not storage
        svc = SolverService(registry, block_width=2, chunk_iters=16)
        rng = np.random.default_rng(3)
        b = rng.standard_normal(n).astype(np.float32)
        t_plain = svc.submit("ani16", b, solver="cg", tol=1e-5,
                             maxiter=4000)
        t_pc = svc.submit("ani16", b, solver="cg", tol=1e-5, maxiter=4000,
                          precond="block_jacobi:24")
        svc.drain()
        assert t_plain.result.converged and t_pc.result.converged
        assert t_pc.result.iters * 2 <= t_plain.result.iters


# ------------------------------------------------- deliberate differences
class TestDeliberateDifferences:
    def test_register_defaults_to_the_card(self, lap, monkeypatch):
        """``device=None`` is the card: without one, register raises."""
        (r, c, v, n), _ = lap
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MatrixRegistry().register("m", rows=r, cols=c, vals=v,
                                      shape=(n, n))

    def test_register_has_no_interpret_or_autotune(self, lap):
        (r, c, v, n), _ = lap
        for kw in ({"interpret": True}, {"autotune_tiles": True}):
            with pytest.raises(TypeError):
                MatrixRegistry().register("m", rows=r, cols=c, vals=v,
                                          shape=(n, n), **CPU, **kw)

    @pytest.mark.parametrize("impl", [None, "ref"])
    def test_cpu_registration_runs_the_plain_version(self, lap, impl):
        (r, c, v, n), _ = lap
        registry = MatrixRegistry()
        registry.register("m", rows=r, cols=c, vals=v, shape=(n, n),
                          dtype=np.float64, impl=impl, **CPU)
        assert registry.operator("m").impl == impl
        execution.reset_launch_counts()
        svc = SolverService(registry, block_width=2)
        t = svc.submit("m", np.ones(n), tol=1e-8)
        svc.drain()
        assert t.result.converged
        assert execution.launch_counts().get("sellcs_spmv", 0) == 0

    def test_keys_carry_numpy_style_dtype_names(self, lap):
        (r, c, v, n), _ = lap
        registry = MatrixRegistry()
        registry.register("m64", rows=r, cols=c, vals=v, shape=(n, n),
                          dtype=np.float64, **CPU)
        registry.register("m16", rows=r, cols=c, vals=v, shape=(n, n),
                          dtype=torch.float64, store_dtype=torch.bfloat16,
                          **CPU)
        svc = SolverService(registry)
        t64 = svc.submit("m64", np.ones(n))
        t16 = svc.submit("m16", np.ones(n), block=True)
        assert t64.key == ("m64", "cg", "float64", "", "float64", "", "")
        assert t16.key == ("m16", "cg", "float64", "", "bfloat16", "block",
                           "")
        assert registry.entry("m64").fingerprint[3] == "float64"

    @pytest.mark.parametrize("block", [False, True])
    def test_chunk_clock_is_read_after_the_done_download(self, reg, lap,
                                                         block):
        """``run_chunk`` returns once the chunk is enqueued, so the service
        reads the chunk's ``done`` flags to the host before its second
        clock read, and hands that one host copy on to the retire."""
        *_, n = lap[0]
        log = []
        vc = VirtualClock()

        def clock():
            log.append("clock")
            return vc()

        svc = SolverService(reg, block_width=2, chunk_iters=4, clock=clock)
        download, run_chunk = svc._download, svc._run_chunk

        def logged_download(t):
            log.append("done" if t.dtype == torch.bool else "download")
            return download(t)

        def logged_run_chunk(batch):
            log.append("chunk")
            done = run_chunk(batch)
            log.append("/chunk")
            vc.advance(1.0)
            return done

        svc._download = logged_download
        svc._run_chunk = logged_run_chunk
        ts = [svc.submit("lap", np.random.default_rng(i).standard_normal(n),
                         tol=1e-4, block=block) for i in range(3)]
        svc.drain()
        assert all(t.result.converged for t in ts)
        chunks = []
        for i, e in enumerate(log):
            if e == "chunk":
                chunks.append(log[i + 1:log.index("/chunk", i)])
        assert len(chunks) == svc.stats["chunks"] > 1
        for seq in chunks:
            # clock, (step), done download, clock: one done read a chunk
            assert seq == ["clock", "done", "clock"], seq
        assert log.count("done") == svc.stats["chunks"]

    def test_refill_uploads_only_the_admitted_columns(self, lap):
        """The zeroed block with the admitted columns equals the
        reference's full host block, bit for bit, after the permute."""
        (r, c, v, n), _ = lap
        registry = MatrixRegistry()
        registry.register("m", rows=r, cols=c, vals=v, shape=(n, n), C=16,
                          sigma=32, dtype=np.float64, **CPU)
        op = registry.operator("m")
        svc = SolverService(registry)
        rng = np.random.default_rng(5)
        cols = [(1, rng.standard_normal(n).astype(np.float32)),
                (4, rng.standard_normal(n))]
        got = svc._upload(op, n, 6, cols)
        full = np.zeros((n, 6), np.float64)
        for j, col in cols:
            full[:, j] = col
        want = op.to_op_space(torch.from_numpy(full))
        assert got.dtype == torch.float64 and torch.equal(got, want)

    def test_refilled_state_equals_a_full_upload(self, lap):
        """A refill's state after the merge equals the one made from the
        full host block (the reference's upload), bit for bit."""
        (r, c, v, n), _ = lap
        registry = MatrixRegistry()
        registry.register("m", rows=r, cols=c, vals=v, shape=(n, n), C=16,
                          sigma=32, dtype=np.float64, **CPU)
        rng = np.random.default_rng(6)
        bs = [rng.standard_normal(n) for _ in range(3)]
        svc = SolverService(registry, block_width=4, chunk_iters=4)
        ts = [svc.submit("m", b, tol=[1e-2, 1e-9, 1e-9][i])
              for i, b in enumerate(bs[:2])]
        while not ts[0].resolved:
            svc.step()
        assert not ts[1].resolved
        (batch,) = svc._batches.values()
        old = batch.state
        svc.submit("m", bs[2], tol=1e-9)
        seen = {}
        merge = batch.merge

        def spy(o, fresh, mask):
            seen["fresh"] = fresh
            return merge(o, fresh, mask)

        batch.merge = spy
        svc._refill(batch)
        (j,) = [j for j, t in enumerate(batch.slots)
                if t is not None and t.b is bs[2]]
        full = np.zeros((n, 4))
        full[:, j] = bs[2]
        tols = torch.ones(4, dtype=torch.float64)
        tols[j] = 1e-9
        op = batch.op
        want = batch.init(op.to_op_space(torch.from_numpy(full)), tols)
        for a, b in zip(seen["fresh"], want):
            assert (a == b) if isinstance(a, int) else torch.equal(a, b)
        mask = np.zeros(4, bool)
        mask[j] = True
        for a, b in zip(batch.state, merge(old, want, mask)):
            assert (a == b) if isinstance(a, int) else torch.equal(a, b)

    @pytest.mark.gpu
    def test_card_registration_launches_b1(self, lap):
        """On the card the registered matrix's chunks launch kernel B1,
        and the answer agrees with the CPU's."""
        need_card()
        (r, c, v, n), Ad = lap
        b = np.random.default_rng(0).standard_normal(n)
        x = {}
        for dev in ("cpu", None):
            registry = MatrixRegistry()
            registry.register("m", rows=r, cols=c, vals=v, shape=(n, n),
                              C=16, sigma=32, dtype=np.float64, device=dev)
            execution.reset_launch_counts()
            svc = SolverService(registry, block_width=2)
            t = svc.submit("m", b, tol=1e-10)
            svc.drain()
            torch.cuda.synchronize()
            assert t.result.converged
            launches = execution.launch_counts().get("sellcs_spmv", 0)
            assert (launches > t.result.iters) == (dev is None)
            x[dev] = t.result.x
        np.testing.assert_allclose(x[None], x["cpu"],
                                   atol=1e-9 * np.abs(x["cpu"]).max())

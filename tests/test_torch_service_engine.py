"""Engine-backed registration in the port's serving runtime: the
counterparts of the JAX package's three engine tests in
``tests/test_service.py`` (``test_engine_backed_matrix``, the engine half
of ``test_precond_registry_caching_and_validation`` and
``test_precond_service_engine_chebyshev``), on host shards, with their
tolerances; the registry's bookkeeping for an engine; the cold-start
iteration hint from ``modeled_iter_seconds``; and, marked ``gpu``, the
same requests on card shards (kernel B1) and on the host plus the card.

Where the reference's engine runs on a one-device mesh, the port's runs
one shard on the host (``devices=["cpu"]``); the two-shard variants split
the rows between two host shards.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import execution
from repro_torch.matrices import laplace3d, matpde
from repro_torch.runtime import (DevicePool, HeterogeneousEngine,
                                 MatrixRegistry, SolverService)
from repro_torch.solvers.operator import DistOperator


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _spd():
    r, c, v, n = matpde(16)
    Ad = np.zeros((n, n)); Ad[r, c] += v
    spd = (Ad @ Ad.T + n * np.eye(n)).astype(np.float32)
    rs, cs = np.nonzero(spd)
    return rs, cs, spd, n


def _rel(A, t):
    return (np.abs(A @ t.result.x - np.asarray(t.b)).max()
            / np.abs(np.asarray(t.b)).max())


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]])
def test_engine_backed_matrix(rng, devices):
    """Sharded matrices go through HeterogeneousEngine/DistOperator
    unchanged."""
    rs, cs, spd, n = _spd()
    eng = HeterogeneousEngine(rs, cs, spd[rs, cs], n, devices=devices, C=8,
                              sigma=16, w_align=4, dtype=np.float32)
    registry = MatrixRegistry()
    registry.register("dist", eng)
    svc = SolverService(registry, block_width=2, chunk_iters=8)
    tickets = [svc.submit("dist", rng.standard_normal(n).astype(np.float32),
                          solver="cg", tol=1e-6, maxiter=300)
               for _ in range(3)]
    svc.drain()
    for t in tickets:
        assert t.result.converged
        assert _rel(spd, t) < 1e-3


def test_precond_registry_caching_and_validation():
    """The engine half: engine-backed matrices reject block_jacobi with a
    clear error (chebyshev is the preconditioner they take)."""
    rs, cs, spd, n = _spd()
    eng = HeterogeneousEngine(rs, cs, spd[rs, cs], n, devices=["cpu"], C=8,
                              sigma=1, w_align=4, dtype=np.float32)
    reg = MatrixRegistry()
    reg.register("eng", eng)
    with pytest.raises(ValueError, match="block_jacobi"):
        reg.preconditioner("eng", "block_jacobi")
    with pytest.raises(ValueError, match="engine-backed"):
        reg.preconditioner("eng", "block_jacobi:8")
    Mc = reg.preconditioner("eng", "chebyshev")
    assert reg.preconditioner("eng", "chebyshev:4") is Mc
    assert reg.stats["precond_builds"] == 1


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]])
def test_precond_service_engine_chebyshev(rng, devices):
    """Chebyshev precond on an engine-backed (DistOperator) matrix: the
    polynomial apply rides the distributed matvec unchanged."""
    r, c, v, n = laplace3d(6)
    eng = HeterogeneousEngine(r, c, v, n, devices=devices, C=8, sigma=16,
                              w_align=4, dtype=np.float32)
    registry = MatrixRegistry()
    registry.register("dist", eng)
    svc = SolverService(registry, block_width=2, chunk_iters=8)
    tickets = [svc.submit("dist",
                          rng.standard_normal(n).astype(np.float32),
                          solver="cg", tol=1e-6, maxiter=400,
                          precond="chebyshev:3")
               for _ in range(3)]
    svc.drain()
    Ad = np.zeros((n, n), np.float32)
    Ad[r, c] += v.astype(np.float32)
    for t in tickets:
        assert t.result.converged
        assert _rel(Ad, t) < 1e-3


def test_engine_entry_bookkeeping():
    """The registry keeps the engine as the matrix, a DistOperator as the
    operator, the global row count and the value-storage dtype; the same
    engine again is a hit, another engine under the name raises."""
    r, c, v, n = laplace3d(5)
    kw = dict(devices=["cpu", "cpu"], C=8, dtype=np.float32)
    eng = HeterogeneousEngine(r, c, v, n, store_dtype="bfloat16", **kw)
    reg = MatrixRegistry()
    reg.register("e", eng)
    e = reg.entry("e")
    assert e.matrix is eng and isinstance(e.op, DistOperator)
    assert e.nglobal == n and e.store_dtype == "bfloat16"
    assert e.op.n == eng.A.n and e.op.device == torch.device("cpu")
    reg.register("e", eng)
    assert reg.stats == dict(reg.stats, builds=1, hits=1)
    with pytest.raises(ValueError, match="different object"):
        reg.register("e", HeterogeneousEngine(r, c, v, n, **kw))


def test_cold_iteration_hint_is_the_engines_model():
    """Before any chunk is measured, a batch on an engine-backed matrix
    carries the engine's roofline critical path as its seconds-per-
    iteration estimate (at the batch's width)."""
    r, c, v, n = laplace3d(5)
    eng = HeterogeneousEngine(r, c, v, n, devices=["cpu", "cpu"], C=8,
                              dtype=np.float32,
                              pool=DevicePool.from_bandwidths([50, 150]))
    reg = MatrixRegistry()
    reg.register("e", eng)
    svc = SolverService(reg, block_width=2, chunk_iters=4)
    svc.submit("e", np.ones(n, np.float32), tol=1e-4, maxiter=50)
    svc.step()
    batch = next(iter(svc._batches.values()), None)
    est = eng.modeled_iter_seconds(nvecs=2)
    assert est > 0
    if batch is not None:              # still running after one chunk
        assert batch.est_iter_s is not None
    assert svc._cold_iter_hint(("e",), reg.entry("e"), 2) == est


@pytest.mark.gpu
@pytest.mark.parametrize("devices", [["cuda"] * 4, ["cuda", "cpu"]])
def test_engine_serving_on_the_card(rng, devices):
    """The same requests on card shards and on the host plus the card:
    every request converges within the reference's tolerance through B1."""
    need_card()
    r, c, v, n = laplace3d(12)
    eng = HeterogeneousEngine(r, c, v, n, devices=devices, C=32, sigma=64,
                              dtype=np.float64)
    reg = MatrixRegistry()
    reg.register("dist", eng)
    svc = SolverService(reg, block_width=2, chunk_iters=8)
    execution.reset_launch_counts()
    tickets = [svc.submit("dist", rng.standard_normal(n), solver="cg",
                          tol=1e-8, maxiter=600,
                          precond=None if i % 2 else "chebyshev:3")
               for i in range(4)]
    svc.drain()
    assert execution.launch_counts()["sellcs_spmv"] > 0
    Ad = np.zeros((n, n)); Ad[r, c] += v
    for t in tickets:
        assert t.result.converged and _rel(Ad, t) < 1e-6

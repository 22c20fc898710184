"""The port's heterogeneous runtime on the CPU: ``DevicePool``,
``plan_split``/``SplitPlan.rebalance``, ``proportional_step`` and the SpMV
cost terms equal to the JAX package's for the same inputs; the
counterparts of ``tests/test_runtime.py``; and the
``HeterogeneousEngine`` on two host shards against the JAX package's
engine on a two-device host mesh (one subprocess for the module, f64,
``impl="ref"``): the split, the fused SpMV within 1e-12 of max|y|, and CG
through ``DistOperator`` with the reference's iteration count (exactly
here; the tolerance would allow one more or less, since the two
packages' SpMVs round differently).

Deliberate differences pinned here: ``detect`` classifies torch devices
(the card by its name, the host as ``"cpu"``, looked up as ``"host
cpu"``), ``detect(None)`` means every card and raises without one, and
the device table has no TPU entries.
"""
import numpy as np
import pytest
import torch

from conftest import run_with_devices

from repro_torch.core import SpmvOpts, execution, from_coo, spmv_ref
from repro_torch.launch.costmodel import spmv_code_balance, spmv_cost
from repro_torch.launch.hillclimb import proportional_step
from repro_torch.matrices import banded_random, matpde
from repro_torch.runtime import (DeviceClass, DevicePool, HeterogeneousEngine,
                                 plan_split)
from repro_torch.runtime import devicepool as tdp
from repro_torch.solvers import cg, make_operator


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules, imported where a test compares with
    them (the ``gpu`` tests run where JAX is not installed)."""
    pytest.importorskip("jax")
    import types
    from repro.launch import costmodel, hillclimb
    from repro.runtime import devicepool, split
    return types.SimpleNamespace(cost=costmodel, step=hillclimb.proportional_step,
                                 dp=devicepool, split=split)


# ------------------------------------------------------- equal to reference
@pytest.mark.parametrize("nvecs", [1, 4, 16])
@pytest.mark.parametrize("val_bytes,idx_bytes", [(8, 4), (4, 4), (2, 4)])
@pytest.mark.parametrize("nnz,nrows", [(1000, 100), (109_800_000, 1_504_002),
                                       (5, 0)])
def test_cost_terms_match_reference(J, nnz, nrows, val_bytes, idx_bytes, nvecs):
    kw = dict(val_bytes=val_bytes, idx_bytes=idx_bytes, nvecs=nvecs)
    t, j = spmv_cost(nnz, nrows, **kw), J.cost.spmv_cost(nnz, nrows, **kw)
    assert (t.flops, t.hbm_bytes, t.coll_bytes, t.detail) == \
        (j.flops, j.hbm_bytes, j.coll_bytes, j.detail)
    for nnzr in (1.0, 73.0, float("inf")):
        assert spmv_code_balance(nnzr=nnzr, rhs_reload=0.5, **kw) == \
            J.cost.spmv_code_balance(nnzr=nnzr, rhs_reload=0.5, **kw)


STEPS = [([1.0, 1.0], [3.0, 1.0], 0.5), ([1.0, 1.0], [3.0, 1.0], 1.0),
         ([0.25, 0.75], [0.02, 0.001], 0.7), ([1, 2, 3], [0, 1, 1], 0.5),
         ([1, 1, 1], [0, 0, 0], 0.5), ([0.5, 0.4999, 1e-4], [1, 1, 1e3], 1.0),
         ([1.0] * 4, [1e-3, 1e3, 1.0, 2.0], 1.0)]


@pytest.mark.parametrize("w,t,step", STEPS, ids=str)
def test_proportional_step_matches_reference(J, w, t, step):
    np.testing.assert_array_equal(proportional_step(w, t, step=step),
                                  J.step(w, t, step=step))


@pytest.mark.parametrize("w,t", [([1.0, -1.0], [1.0, 1.0]),
                                 ([1.0, 1.0], [1.0, -1.0]), ([1.0], [1, 2])])
def test_proportional_step_validates_like_reference(J, w, t):
    for fn in (proportional_step, J.step):
        with pytest.raises(ValueError):
            fn(w, t)


def _rowlen(n, seed):
    rl = np.random.default_rng(seed).integers(0, 9, n)
    rl[: n // 7] += 40
    return rl


@pytest.mark.parametrize("by_nnz", [False, True])
@pytest.mark.parametrize("align", [1, 8, 32])
@pytest.mark.parametrize("w", [[1, 2.75, 0.5], [1000.0, 1, 1, 1], [50, 150],
                               [0.013, 0.987]], ids=str)
def test_plan_split_and_rebalance_match_reference(J, w, align, by_nnz):
    n = 4099
    rl = _rowlen(n, 1) if by_nnz else None
    t = plan_split(n, w, align=align, rowlen=rl)
    j = J.split.plan_split(n, w, align=align, rowlen=rl)
    for _ in range(4):
        assert t.ranges == j.ranges and t.weights == j.weights
        assert (t.generation, t.align, t.by_nnz) == \
            (j.generation, j.align, j.by_nnz)
        np.testing.assert_array_equal(t.sizes, j.sizes)
        times = t.sizes / t.sizes.sum() / np.arange(1, len(w) + 1)
        assert t.imbalance(times) == j.imbalance(times)
        t, j = t.rebalance(times, step=0.7), j.rebalance(times, step=0.7)


def _classes(pool):
    return [(c.name, c.count, c.mem_bw, c.peak_flops) for c in pool.classes]


@pytest.mark.parametrize("bws", [[50, 150, 150], [3.0e12, 2.0e10],
                                 [100], [1, 2, 3, 4]])
def test_pool_matches_reference(J, bws):
    t, j = DevicePool.from_bandwidths(bws), J.dp.DevicePool.from_bandwidths(bws)
    assert _classes(t) == _classes(j) and repr(t) == repr(j)
    np.testing.assert_array_equal(t.device_weights(), j.device_weights())
    for kw in (dict(nnz=109_800_000, nrows=1_504_002, val_bytes=8),
               dict(nnz=1000, nrows=10, val_bytes=2, nvecs=64)):
        np.testing.assert_array_equal(t.device_weights(**kw),
                                      j.device_weights(**kw))
    for nnzr in (64.0, 1e9):
        assert t.aggregate_spmv_gflops(nnzr=nnzr) == \
            j.aggregate_spmv_gflops(nnzr=nnzr)


def test_device_table_keeps_the_papers_entries_and_no_tpu(J):
    for key in ("gpu", "phi", "cpu"):
        assert tdp.KNOWN_DEVICE_SPECS[key] == J.dp.KNOWN_DEVICE_SPECS[key]
    assert not any("tpu" in k for k in tdp.KNOWN_DEVICE_SPECS)
    assert {"h100", "host cpu"} <= set(tdp.KNOWN_DEVICE_SPECS)
    assert tdp._lookup_spec("NVIDIA H100 80GB HBM3", "gpu") == \
        tdp.KNOWN_DEVICE_SPECS["h100"]
    # another card goes to the paper's K20, as in the reference
    assert tdp._lookup_spec("NVIDIA A100-SXM4-40GB", "gpu") == \
        J.dp._lookup_spec("NVIDIA A100-SXM4-40GB", "gpu")
    assert tdp._lookup_spec("mystery") == J.dp._lookup_spec("mystery")


def test_detect_classifies_torch_devices():
    pool = DevicePool.detect(["cpu", "cpu"])
    assert pool.ndevices == 2 and len(pool.classes) == 1
    c = pool.classes[0]
    assert (c.name, c.count) == ("cpu", 2)
    assert (c.mem_bw, c.peak_flops) == tuple(
        tdp.KNOWN_DEVICE_SPECS["host cpu"][k] for k in ("mem_bw",
                                                        "peak_flops"))
    assert pool.devices == (torch.device("cpu"),) * 2
    np.testing.assert_array_equal(pool.device_weights(), [0.5, 0.5])
    assert DevicePool.from_bandwidths([1]).devices is None


def test_detect_none_is_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePool.detect()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePool.detect(["cpu", "cuda"])


@pytest.mark.gpu
def test_detect_names_the_card():
    need_card()
    pool = DevicePool.detect(["cuda", "cpu"])
    assert [c.name for c in pool.classes] == [
        torch.cuda.get_device_name(0), "cpu"]
    assert pool.devices[0] == torch.device("cuda", 0)
    assert DevicePool.detect().ndevices == torch.cuda.device_count()
    w = pool.device_weights()
    assert w[0] > w[1]


# --------------------------------------------- counterparts of test_runtime
class TestDevicePool:
    def test_detect_host(self):
        pool = DevicePool.detect(["cpu"])
        assert pool.ndevices >= 1
        assert len(pool.device_classes()) == pool.ndevices

    def test_synthetic_paper_node(self):
        """Paper Table 1: CPU 50 + GPU 150 + PHI 150 GB/s."""
        pool = DevicePool.from_bandwidths([50, 150, 150])
        w = pool.device_weights()
        assert np.allclose(w, [50 / 350, 150 / 350, 150 / 350])
        # min code balance 6 B/flop (f64 vals + i32 idx) -> 350/6 Gflop/s
        pred = pool.aggregate_spmv_gflops(nnzr=1e9)   # huge row amortizes y
        assert abs(pred - 350.0 / 6.0) < 1.0

    def test_code_balance_reference_point(self):
        assert spmv_code_balance(val_bytes=8, idx_bytes=4,
                                 nnzr=1e12) == pytest.approx(6.0)
        cb4 = spmv_code_balance(val_bytes=8, idx_bytes=4, nvecs=4, nnzr=1e12)
        assert cb4 < 6.0 / 2

    def test_roofline_time(self):
        pool = DevicePool.from_bandwidths([100])
        cost = spmv_cost(10_000, 100, val_bytes=4)
        t = pool.classes[0].time_for(cost)
        assert t == pytest.approx(cost.hbm_bytes / 100e9)
        assert isinstance(pool.classes[0], DeviceClass)


class TestSplitPlan:
    def test_split_sums_and_alignment(self):
        for n, align in [(1000, 32), (997, 8), (64, 32), (12345, 16)]:
            p = plan_split(n, [1, 2.75, 0.5], align=align)
            assert p.sizes.sum() == n
            starts = [s for s, _ in p.ranges]
            assert all(s % align == 0 for s in starts)
            assert p.ranges[0][0] == 0 and p.ranges[-1][1] == n
            assert all(p.ranges[i][1] == p.ranges[i + 1][0]
                       for i in range(p.nshards - 1))

    def test_no_empty_shards_under_skew(self):
        p = plan_split(256, [1000.0, 1.0, 1.0, 1.0], align=32)
        assert (p.sizes > 0).all()
        assert p.sizes.sum() == 256

    def test_proportionality(self):
        p = plan_split(100_000, [1.0, 3.0], align=32)
        assert abs(p.sizes[1] / p.sizes[0] - 3.0) < 0.01

    def test_nnz_criterion(self):
        rowlen = np.concatenate([np.full(100, 50), np.full(900, 5)])
        p = plan_split(1000, [1, 1], align=4, rowlen=rowlen)
        nnz = p.shard_nnz()
        assert abs(nnz[0] - nnz[1]) / nnz.sum() < 0.1
        assert p.sizes.sum() == 1000

    def test_rebalance_one_step_moves_toward_measured(self):
        p = plan_split(10_000, [1.0, 1.0], align=8)
        p2 = p.rebalance([3.0, 1.0], step=1.0)
        assert p2.generation == 1
        assert p2.weights[0] < p2.weights[1]

    def test_rebalance_converges_on_skewed_pool(self):
        speed = np.array([1.0, 3.0])
        p = plan_split(30_000, [1.0, 1.0], align=8)
        for _ in range(8):
            times = (p.sizes / p.sizes.sum()) / speed
            p = p.rebalance(times, step=0.7)
        w = np.asarray(p.weights)
        assert abs(w[1] / w[0] - 3.0) < 0.15, w
        times = (p.sizes / p.sizes.sum()) / speed
        assert p.imbalance(times) < 1.02

    def test_proportional_step_validates(self):
        with pytest.raises(ValueError):
            proportional_step([1.0, -1.0], [1.0, 1.0])


class TestEngineSingleDevice:
    def test_spmv_matches_dense(self, rng):
        r, c, v, n = matpde(16)
        A = np.zeros((n, n)); A[r, c] += v
        eng = HeterogeneousEngine(r, c, v, n, devices=["cpu"], C=8,
                                  sigma=16, w_align=4, dtype=np.float32)
        x = rng.standard_normal((n, 2)).astype(np.float32)
        y, _ = eng.spmv(x)
        assert np.allclose(y.numpy(), A @ x, atol=1e-3)

    def test_rebalance_keeps_correctness(self, rng):
        r, c, v, n = matpde(12)
        A = np.zeros((n, n)); A[r, c] += v
        eng = HeterogeneousEngine(r, c, v, n, devices=["cpu"], C=8, sigma=8,
                                  w_align=4, dtype=np.float32)
        eng.rebalance()          # modeled-times fallback path
        x = rng.standard_normal(n).astype(np.float32)
        y, _ = eng.spmv(x)
        assert np.allclose(y.numpy(), A @ x, atol=1e-3)


def test_engine_validates_devices():
    r, c, v, n = matpde(6)
    with pytest.raises(ValueError, match="nshards=3 must equal"):
        HeterogeneousEngine(r, c, v, n, devices=["cpu", "cpu"], nshards=3,
                            C=8)
    with pytest.raises(ValueError, match="expected 2 shard weights"):
        HeterogeneousEngine(r, c, v, n, devices=["cpu", "cpu"],
                            weights=[1.0], C=8)
    eng = HeterogeneousEngine(r, c, v, n, devices=["cpu"] * 3, C=8,
                              pool=DevicePool.from_bandwidths([50, 150]))
    assert eng.nshards == 3 and "shards=3" in repr(eng)


def test_engine_defaults_to_every_card(monkeypatch):
    """No devices and no pool: the pool of every card, which raises
    without one; a synthetic pool without devices puts the shards on the
    card too.  Nothing falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r, c, v, n = matpde(6)
    for kw in ({}, {"pool": DevicePool.from_bandwidths([50, 150])}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HeterogeneousEngine(r, c, v, n, C=8, **kw)


# ------------------------------------------- two host shards vs reference
REF_CODE = """
import numpy as np, jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.runtime import DevicePool, HeterogeneousEngine
from repro.core.spmv import SpmvOpts
from repro.solvers import cg, make_operator
from repro.matrices import banded_random, matpde

out = {{}}
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
pool = DevicePool.from_bandwidths([50, 150])
r, c, v, n = banded_random(400, bw=8, density=0.6, seed=4)
eng = HeterogeneousEngine(r, c, v, n, mesh=mesh, pool=pool, C=8, sigma=16,
                          w_align=4, dtype=np.float64)
x = np.random.default_rng(0).standard_normal((n, 2))
y, dots = eng.spmv(x, opts=SpmvOpts(alpha=2.0, gamma=0.5, dot_yy=True,
                                    dot_xy=True, dot_xx=True))
out.update(y=y, dots=dots, ranges=np.asarray(eng.plan.ranges),
           modeled=eng.modeled_shard_times(), iter_s=eng.modeled_iter_seconds(4))
eng.rebalance([3.0, 1.0])
out.update(y_rb=eng.spmv(x)[0], ranges_rb=np.asarray(eng.plan.ranges),
           weights_rb=np.asarray(eng.plan.weights))
r, c, v, n = matpde(16, beta_c=0.0)
engs = HeterogeneousEngine(r, c, v, n, mesh=mesh, pool=pool, C=8, sigma=16,
                           w_align=4, dtype=np.float64)
op = make_operator(engs)
b = np.random.default_rng(1).standard_normal((n, 2))
res = cg(op, op.to_op_space(jnp.asarray(b)), tol=1e-10, maxiter=600)
out.update(cg_iters=res.iters, cg_x=op.from_op_space(res.x),
           cg_conv=res.converged)
np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("SUBPROCESS_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    path = str(tmp_path_factory.mktemp("engine_ref") / "ref.npz")
    assert "SUBPROCESS_OK" in run_with_devices(REF_CODE.format(path=path), 2)
    return dict(np.load(path))


POOL = dict(devices=["cpu", "cpu"], C=8, sigma=16, w_align=4,
            dtype=np.float64)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return np.abs(got - want).max() / np.abs(want).max()


class TestEngineMultiShard:
    """The reference's ``test_engine_end_to_end_two_shards``, its five
    checks, on two host shards, each against the reference engine run."""

    @pytest.fixture(scope="class")
    def eng(self):
        r, c, v, n = banded_random(400, bw=8, density=0.6, seed=4)
        return HeterogeneousEngine(
            r, c, v, n, pool=DevicePool.from_bandwidths([50, 150]), **POOL)

    @pytest.fixture(scope="class")
    def x(self):
        return np.random.default_rng(0).standard_normal((400, 2))

    def test_overlap_bit_identical_and_correct(self, eng, x):
        r, c, v, n = banded_random(400, bw=8, density=0.6, seed=4)
        A = np.zeros((n, n)); A[r, c] += v
        y1, _ = eng.spmv(x, overlap=True)
        y2, _ = eng.spmv(x, overlap=False)
        assert torch.equal(y1, y2), "overlap changed bits"
        As = from_coo(r, c, v, (n, n), C=8, sigma=16, w_align=4,
                      dtype=np.float64, device="cpu")
        yr = As.unpermute(spmv_ref(As, As.permute(torch.from_numpy(x)))[0])
        assert _rel(y1, yr.numpy()) <= 1e-12
        assert _rel(y1, A @ x) <= 1e-12

    def test_double_buffer_chain(self, eng, x):
        xs = eng.A.distribute_vec(torch.from_numpy(x[:, :1]))
        run_db = eng.make_matvec(nvecs=1, double_buffer=True)
        run_nb = eng.make_matvec(nvecs=1)
        w, stg = xs, None
        for _ in range(3):
            w, _, stg = run_db(w, staging=stg)
        w2 = xs
        for _ in range(3):
            w2, _, _ = run_nb(w2)
        assert stg.slots == 2 and stg.calls == 3
        assert all(torch.equal(a, b) for a, b in zip(w, w2))

    def test_fused_gamma_and_dots_match_reference(self, eng, x, ref):
        y, dots = eng.spmv(x, opts=SpmvOpts(alpha=2.0, gamma=0.5, dot_yy=True,
                                            dot_xy=True, dot_xx=True))
        assert _rel(y, ref["y"]) <= 1e-12
        assert dots.dtype == torch.float64
        np.testing.assert_allclose(dots.numpy(), ref["dots"], rtol=1e-12)

    def test_split_follows_the_pool(self, eng, ref):
        sizes = eng.plan.sizes
        assert abs(sizes[1] / sizes[0] - 3.0) < 0.3, sizes
        np.testing.assert_array_equal(np.asarray(eng.plan.ranges),
                                      ref["ranges"])
        np.testing.assert_allclose(eng.modeled_shard_times(), ref["modeled"],
                                   rtol=1e-15)
        assert eng.modeled_iter_seconds(4) == pytest.approx(
            float(ref["iter_s"]), rel=1e-15)

    def test_cg_iterations_match_reference(self, ref):
        r, c, v, n = matpde(16, beta_c=0.0)
        A = np.zeros((n, n)); A[r, c] += v
        eng = HeterogeneousEngine(
            r, c, v, n, pool=DevicePool.from_bandwidths([50, 150]), **POOL)
        op = make_operator(eng)
        assert op.device == torch.device("cpu") and op.n == eng.A.n
        b = np.random.default_rng(1).standard_normal((n, 2))
        res = cg(op, op.to_op_space(torch.from_numpy(b)), tol=1e-10,
                 maxiter=600)
        assert bool(res.converged.all()) and bool(ref["cg_conv"].all())
        assert res.iters == int(ref["cg_iters"])
        xs = op.from_op_space(res.x).numpy()
        assert np.abs(A @ xs - b).max() < 1e-8
        assert _rel(xs, ref["cg_x"]) <= 1e-8


def test_rebalance_matches_reference_and_moves_the_mask(ref):
    """A measured step redistributes exactly as the reference's, the
    matvec stays right, and the operator's mask follows the new matrix."""
    r, c, v, n = banded_random(400, bw=8, density=0.6, seed=4)
    x = np.random.default_rng(0).standard_normal((n, 2))
    eng = HeterogeneousEngine(r, c, v, n,
                              pool=DevicePool.from_bandwidths([50, 150]),
                              **POOL)
    op = eng.operator()
    mask0 = op._mask
    assert op._mask is mask0                        # cached per matrix
    A0 = eng.A
    eng.rebalance([3.0, 1.0])
    assert eng.A is not A0 and eng.plan.generation == 1
    np.testing.assert_array_equal(np.asarray(eng.plan.ranges),
                                  ref["ranges_rb"])
    np.testing.assert_array_equal(eng.plan.weights, ref["weights_rb"])
    assert _rel(eng.spmv(x)[0], ref["y_rb"]) <= 1e-12
    mask1 = op._mask
    assert mask1 is not mask0 and mask1.shape == (eng.A.n, 1)
    assert int(mask1.sum()) == n
    y_op = op.from_op_space(op.mv(op.to_op_space(torch.from_numpy(x))))
    assert _rel(y_op, eng.spmv(x)[0].numpy()) == 0.0


def test_rebalance_at_fixed_point_keeps_matvecs():
    r, c, v, n = matpde(10)          # 100 rows: blocks of 32 absorb a nudge
    eng = HeterogeneousEngine(r, c, v, n, devices=["cpu", "cpu"], C=32,
                              pool=DevicePool.from_bandwidths([100, 100]))
    run = eng.make_matvec()
    A = eng.A
    eng.rebalance()                  # modeled times of a perfect pool
    assert eng.A is A and eng.make_matvec() is run
    assert eng.plan.generation == 1


def test_measured_times_feed_the_rebalance():
    """``times`` from a matvec are per-shard seconds, usable as
    ``rebalance`` input (the loop chip_smoke.py runs on the card)."""
    r, c, v, n = matpde(12)
    eng = HeterogeneousEngine(r, c, v, n, devices=["cpu", "cpu"], C=8,
                              dtype=np.float64)
    xs = eng.A.distribute_vec(torch.ones(n, 2, dtype=torch.float64))
    t = {}
    eng.make_matvec(nvecs=2)(xs, times=t)
    assert len(t["shards"]) == 2 and all(s > 0 for s in t["shards"])
    assert t["transfer"] == 0.0
    eng.rebalance(t["shards"])
    assert eng.plan.generation == 1


@pytest.mark.gpu
@pytest.mark.parametrize("devices", [["cuda", "cpu"], ["cpu", "cuda"],
                                     ["cuda"] * 2])
def test_engine_cg_on_the_card(devices):
    """CG through DistOperator on card shards (B1) and on the host plus
    the card, against the same solve on two host shards."""
    need_card()
    r, c, v, n = matpde(16, beta_c=0.0)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal((n, 2)))
    res = {}
    for key, devs in (("host", ["cpu", "cpu"]), ("card", devices)):
        eng = HeterogeneousEngine(
            r, c, v, n, devices=devs, C=8, sigma=16, w_align=4,
            dtype=np.float64, pool=DevicePool.from_bandwidths([50, 150]))
        op = eng.operator()
        execution.reset_launch_counts()
        out = cg(op, op.to_op_space(b.to(op.device)), tol=1e-10, maxiter=600)
        torch.cuda.synchronize()
        launches = execution.launch_counts().get("sellcs_spmv", 0)
        res[key] = (out, op.from_op_space(out.x).cpu(), launches)
    (h, xh, _), (g, xg, launches) = res["host"], res["card"]
    assert op.device.type == "cuda"
    assert bool(g.converged.all()) and abs(g.iters - h.iters) <= 1
    assert launches > 0
    assert _rel(xg, xh.numpy()) <= 1e-8

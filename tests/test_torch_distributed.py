"""The port's distributed SELL-C-sigma SpMV (``repro_torch.core.distributed``
and ``runtime/pipeline.py``) on host shards, against the JAX package.

* ``DistSellCS``: the value shards and integer maps equal the
  reference's ``dist_from_coo`` exactly, through the layout mapping — each
  shard keeps its own ``nrows_pad`` (the reference pads every shard to
  ``m_pad``), so a reference row ``p * m_pad + slot`` is the port's
  ``offset_p + slot``, and the reference's padding past a shard's own
  rows and chunks holds nothing;
* the distributed SpMV against the port's one-device ``spmv_ref`` and a
  dense product (1e-12 of max|y| in float64, the reference's tolerances
  in float32), overlap against no overlap and the double-buffered chain
  against the unbuffered one bit for bit, the shift with fused dots,
  narrow value shards and the halo-compression bound;
* at 2 and 4 shards, float64, the reference's own multi-shard pipeline
  (``dist_spmv`` and the engine, ``impl="ref"``) run once for the module
  in one subprocess with forced host devices: the port within 1e-12 of
  max|y|.

The ``gpu``-marked tests run card shards (kernel B1) against the same
split on the host, and the double-buffer slots under asynchronous
copies.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import run_with_devices

from repro_torch.core import SpmvOpts, execution, from_coo, spmv_ref
from repro_torch.core import distributed as tdist
from repro_torch.core.distributed import (Staging, dist_from_coo, dist_spmv,
                                          make_dist_spmv)
from repro_torch.matrices import banded_random, matpde
from repro_torch.runtime import DevicePool, HeterogeneousEngine
from repro_torch.runtime.pipeline import init_staging, make_pipeline_spmv


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _dense(r, c, v, n):
    A = np.zeros((n, n))
    np.add.at(A, (r, c), v)
    return A


def _rel(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    return np.abs(got - want).max() / np.abs(want).max()


# ----------------------------------------------------- maps vs reference
CASES = {
    "equal-8": dict(P=8, kw=dict(C=8, sigma=16, w_align=4)),
    "paper-weights": dict(P=8, kw=dict(weights=[50, 150, 150, 50, 150, 150,
                                                50, 150], C=8, sigma=32,
                                       w_align=4)),
    "by-nnz-4": dict(P=4, kw=dict(by_nnz=True, C=8, sigma=16, w_align=4)),
    "two-skewed": dict(P=2, kw=dict(weights=[0.03, 0.97], C=32, sigma=64)),
    "one-shard": dict(P=1, kw=dict(C=16, sigma=32)),
    "ranges": dict(P=3, kw=dict(ranges=[(0, 64), (64, 96), (96, 400)], C=8)),
    "bf16-store": dict(P=4, kw=dict(C=8, sigma=16, w_align=4,
                                    store_dtype="bfloat16"), dtype=np.float32),
}


def _build_pair(case, dtype=np.float64, seed=2):
    # the JAX package, imported here: the gpu tests run where it is not
    jax = pytest.importorskip("jax")
    from repro.core import distributed as jdist
    c = CASES[case]
    r, cc, v, n = banded_random(400, bw=8, density=0.6, seed=seed)
    kw = dict(c["kw"])
    dtype = c.get("dtype", dtype)
    jkw = dict(kw)
    if "store_dtype" in kw:
        jkw["store_dtype"] = jax.numpy.bfloat16
    with jax.enable_x64(dtype == np.float64):
        J = jdist.dist_from_coo(r, cc, v, n, nshards=c["P"], dtype=dtype,
                                **jkw)
        J = jax.tree_util.tree_map(np.asarray, J)
    T = dist_from_coo(r, cc, v, n, nshards=c["P"], devices=["cpu"] * c["P"],
                      dtype=dtype, **kw)
    return T, J, (r, cc, v, n)


@pytest.mark.parametrize("case", list(CASES))
def test_maps_and_shards_match_reference(case):
    T, J, (r, c, v, n) = _build_pair(case)
    for f in ("nshards", "C", "sigma", "w_align", "nrows", "m_pad",
              "max_msg", "h_max", "row_ranges", "shard_nnz",
              "compute_dtype"):
        assert getattr(T, f) == getattr(J, f), f
    np.testing.assert_array_equal(T.send_idx, J.send_idx)
    np.testing.assert_array_equal(T.halo_idx, J.halo_idx)
    assert T.comm_volume == J.comm_volume
    for p, s in enumerate(T.shards):
        for part, pre in ((s.local, "l_"), (s.remote, "r_")):
            cap, nck = part.cap, part.nchunks
            for f, ref in (("vals", "vals"), ("cols", "cols"),
                           ("rowids", "rowids")):
                want = getattr(J, pre + ref)[p]
                np.testing.assert_array_equal(_host(getattr(part, f)),
                                              _host(want[:cap]))
                assert not _host(want[cap:]).any()
            np.testing.assert_array_equal(part.chunk_off.numpy(),
                                          getattr(J, pre + "off")[p, :nck])
            np.testing.assert_array_equal(part.chunk_len.numpy(),
                                          getattr(J, pre + "len")[p, :nck])
            assert not getattr(J, pre + "len")[p, nck:].any()
            assert part.vals.dtype == s.local.vals.dtype
        # g2l: the reference's row p up to this shard's own nrows_pad
        m = s.nrows_pad
        np.testing.assert_array_equal(T.g2l[p], J.g2l[p, :m])
        np.testing.assert_array_equal(s.g2l.numpy(), T.g2l[p])
        assert (J.g2l[p, m:] == -1).all()
        # the halo gather: the stack row of each (owner, rank) entry
        h = s.nhalo
        ent = J.halo_idx[p, :h]
        owner, rank = ent // T.max_msg, ent % T.max_msg
        np.testing.assert_array_equal(
            s.halo_gidx.numpy()[:h],
            (owner * T.nshards + p) * T.max_msg + rank)
    # pos_of_global: reference p * m_pad + slot -> port offset_p + slot
    offsets = np.array([s.offset for s in T.shards])
    jp = J.pos_of_global
    np.testing.assert_array_equal(T.pos_of_global,
                                  offsets[jp // J.m_pad] + jp % J.m_pad)
    assert T.n == sum(s.nrows_pad for s in T.shards) <= J.nshards * J.m_pad


def test_store_dtype_shards_stay_narrow():
    """bf16 value shards (local and remote), f32 vectors and halos, the
    SpMV within bf16 tolerance of dense, and the storage axis off
    bit-identical to the classic build (the reference's test)."""
    r, c, v, n = banded_random(400, bw=8, density=0.6, seed=9)
    A = _dense(r, c, v, n)
    kw = dict(nshards=8, devices=["cpu"] * 8, C=8, sigma=16, w_align=4,
              dtype=np.float32)
    D = dist_from_coo(r, c, v, n, store_dtype=torch.bfloat16, **kw)
    assert all(s.local.vals.dtype == torch.bfloat16
               and s.remote.vals.dtype == torch.bfloat16 for s in D.shards)
    assert D.dtype == torch.float32 and D.compute_dtype == "float32"
    x = np.random.default_rng(0).standard_normal((n, 2)).astype(np.float32)
    y, _ = dist_spmv(D, None, x)
    assert y.dtype == torch.float32
    ref = A @ x
    assert np.abs(y.numpy() - ref).max() / max(1.0, np.abs(ref).max()) < 2e-2
    y0, _ = dist_spmv(dist_from_coo(r, c, v, n, **kw), None, x)
    y1, _ = dist_spmv(dist_from_coo(r, c, v, n, store_dtype=None, **kw),
                      None, x)
    assert torch.equal(y0, y1)


def test_halo_compression_bounds_comm():
    """Remote-column compression (Fig. 3): halo volume tracks the band
    width, not the matrix size."""
    r, c, v, n = banded_random(1024, bw=4, density=1.0, seed=7)
    D = dist_from_coo(r, c, v, n, nshards=8, devices=["cpu"] * 8, C=8,
                      sigma=1, w_align=4, dtype=np.float32)
    assert D.max_msg <= 8, D.max_msg
    assert D.h_max <= 16, D.h_max
    assert all(s.nhalo <= 2 * 4 for s in D.shards)


# --------------------------------------------------------- the SpMV itself
@pytest.mark.parametrize("P,weights", [(1, None), (2, [50, 150]), (4, None),
                                       (8, [50, 150, 150, 50, 150, 150, 50,
                                            150])])
@pytest.mark.parametrize("gen", ["matpde", "banded"])
def test_spmv_matches_one_device_and_dense(gen, P, weights):
    if gen == "matpde":
        r, c, v, n = matpde(20)
    else:
        r, c, v, n = banded_random(640, bw=10, density=0.7, seed=2)
    A = _dense(r, c, v, n)
    D = dist_from_coo(r, c, v, n, nshards=P, devices=["cpu"] * P,
                      weights=weights, C=8, sigma=16, w_align=4,
                      dtype=np.float64)
    x = np.random.default_rng(0).standard_normal((n, 3))
    y, dots = dist_spmv(D, None, x)
    assert dots is None
    As = from_coo(r, c, v, (n, n), C=8, sigma=16, w_align=4,
                  dtype=np.float64, device="cpu")
    yr = As.unpermute(spmv_ref(As, As.permute(torch.from_numpy(x)))[0])
    assert _rel(y, yr.numpy()) <= 1e-12
    assert _rel(y, A @ x) <= 1e-12
    y1, _ = dist_spmv(D, None, x[:, 0])
    assert y1.shape == (n,) and _rel(y1, A @ x[:, 0]) <= 1e-12


def test_float32_matches_dense():
    """The reference's float32 checks (its tolerances)."""
    r, c, v, n = banded_random(512, bw=12, density=0.5, seed=3)
    A = _dense(r, c, v, n)
    D = dist_from_coo(r, c, v, n, nshards=8, devices=["cpu"] * 8,
                      by_nnz=True, C=8, sigma=16, w_align=4, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    y, _ = dist_spmv(D, None, x)
    assert y.dtype == torch.float32
    assert np.allclose(y.numpy(), A @ x, atol=1e-3)


def test_overlap_and_no_overlap_agree_bitwise():
    """Fig. 5: the overlap modes differ only in schedule, not result."""
    r, c, v, n = banded_random(400, bw=8, density=0.6, seed=4)
    D = dist_from_coo(r, c, v, n, nshards=8, devices=["cpu"] * 8, C=8,
                      sigma=16, w_align=4, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal((n, 2)).astype(np.float32)
    y1, _ = dist_spmv(D, None, x, overlap=True)
    y2, _ = dist_spmv(D, None, x, overlap=False)
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("P", [2, 4])
def test_gamma_shift_with_fused_dots(P):
    r, c, v, n = banded_random(256, bw=6, density=0.7, seed=6)
    A = _dense(r, c, v, n)
    D = dist_from_coo(r, c, v, n, nshards=P, devices=["cpu"] * P, C=8,
                      sigma=16, w_align=4, dtype=np.float64)
    x = np.random.default_rng(0).standard_normal((n, 2))
    gamma = np.array([0.5, -1.25])
    opts = SpmvOpts(alpha=2.0, gamma=gamma, dot_yy=True, dot_xy=True,
                    dot_xx=True)
    y, dots = dist_spmv(D, None, x, opts=opts)
    ref = 2.0 * (A @ x - gamma * x)
    assert _rel(y, ref) <= 1e-12
    assert dots.dtype == torch.float64 and dots.shape == (3, 2)
    np.testing.assert_allclose(dots.numpy(), [(ref * ref).sum(0),
                                              (x * ref).sum(0),
                                              (x * x).sum(0)], rtol=1e-12)


def test_axpby_through_the_pipeline():
    """``with_y`` and per-column (alpha, beta) coefficients; a shift
    needs a pipeline built for one."""
    r, c, v, n = matpde(12)
    A = _dense(r, c, v, n)
    D = dist_from_coo(r, c, v, n, nshards=3, devices=["cpu"] * 3, C=8,
                      dtype=np.float64)
    rng = np.random.default_rng(1)
    x, y0 = rng.standard_normal((n, 2)), rng.standard_normal((n, 2))
    run = make_pipeline_spmv(D, nvecs=2, with_y=True, dot_yy=True)
    opts = SpmvOpts(alpha=torch.tensor([2.0, -1.0]),
                    beta=torch.tensor([0.5, 3.0]))
    ys, dots, stg = run(D.distribute_vec(x), D.distribute_vec(y0), opts)
    assert stg is None
    ref = np.array([2.0, -1.0]) * (A @ x) + np.array([0.5, 3.0]) * y0
    assert _rel(D.collect_vec(ys), ref) <= 1e-12
    np.testing.assert_allclose(dots[0].numpy(), (ref * ref).sum(0),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="with_y"):
        run(D.distribute_vec(x))
    with pytest.raises(ValueError, match="has_gamma"):
        run(D.distribute_vec(x), D.distribute_vec(y0), SpmvOpts(gamma=1.0))


def test_double_buffered_chain_is_bit_identical():
    r, c, v, n = banded_random(400, bw=8, density=0.6, seed=4)
    D = dist_from_coo(r, c, v, n, nshards=4, devices=["cpu"] * 4, C=8,
                      sigma=16, w_align=4, dtype=np.float64)
    xs = D.distribute_vec(np.random.default_rng(0).standard_normal((n, 2)))
    run_db = make_pipeline_spmv(D, nvecs=2, double_buffer=True)
    run_nb = make_pipeline_spmv(D, nvecs=2)
    w, stg = xs, init_staging(D, 2, D.dtype)
    for _ in range(5):
        w, _, stg = run_db(w, staging=stg)
    w2 = xs
    for _ in range(5):
        w2, _, _ = run_nb(w2)
    assert all(torch.equal(a, b) for a, b in zip(w, w2))
    assert stg.calls == 5


class _Event:
    """Stands in for a CUDA event: records that it was waited on."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def synchronize(self):
        self.log.append(self.name)


@pytest.mark.parametrize("slots", [1, 2])
def test_a_slot_waits_for_the_copies_that_read_it(slots):
    """``Staging.take`` hands out the slots in turn and waits, first, on
    the events the slot's previous call left: with two slots the call
    before last's, with one the previous call's."""
    r, c, v, n = matpde(8)
    D = dist_from_coo(r, c, v, n, nshards=2, devices=["cpu"] * 2, C=8)
    stg = Staging(D, 1, D.dtype, slots=slots)
    log = []
    for k in range(5):
        slot = stg.take()
        assert slot == k % slots
        assert log == ([] if k < slots else [f"copy {k - slots}"])
        log.clear()
        stg.read_done[slot].append(_Event(log, f"copy {k}"))


def test_single_shard_has_no_exchange():
    """One shard: no halo, so no pack, copy or remote SpMV."""
    r, c, v, n = matpde(10)
    D = dist_from_coo(r, c, v, n, nshards=1, devices=["cpu"], C=8)
    assert not D.has_halo and D.shards[0].remote.nnz == 0
    assert (D.max_msg, D.h_max) == (1, 1)
    y, _ = dist_spmv(D, ["cpu"], np.ones(n))
    assert _rel(y, _dense(r, c, v, n) @ np.ones(n)) <= 1e-12


def test_devices_are_checked(monkeypatch):
    r, c, v, n = matpde(6)
    with pytest.raises(ValueError, match="expected 2 devices"):
        dist_from_coo(r, c, v, n, nshards=2, devices=["cpu"])
    D = dist_from_coo(r, c, v, n, nshards=2, devices=["cpu", "cpu"], C=8)
    # shards on two cards and the host: allowed, and solver vectors live
    # on the first card in shard order
    monkeypatch.setattr(tdist, "canonical_device", torch.device)
    devs = tdist._check_devices(["cuda:0", "cpu", "cuda:1"], 3)
    assert devs == tuple(map(torch.device, ["cuda:0", "cpu", "cuda:1"]))
    monkeypatch.undo()
    D3 = dist_from_coo(r, c, v, n, nshards=3, devices=["cpu"] * 3, C=8)
    placed = dataclasses.replace(D3, shards=tuple(
        dataclasses.replace(s, device=d) for s, d in zip(D3.shards, devs)))
    assert placed.home == torch.device("cuda:0")
    assert placed.cards == (torch.device("cuda:0"), torch.device("cuda:1"))
    assert D.on(["cpu", "cpu"]) is D
    run = make_dist_spmv(D, ["cpu", "cpu"])
    assert run.A is D


# ---------------------------------------- the reference's multi-shard runs
REF_CODE = """
import numpy as np, jax
jax.config.update("jax_enable_x64", True)
from jax.sharding import Mesh
from repro.core.distributed import dist_from_coo, dist_spmv
from repro.core.spmv import SpmvOpts
from repro.runtime import DevicePool, HeterogeneousEngine
from repro.matrices import banded_random, matpde

out = {{}}
opts = SpmvOpts(alpha=-1.5, gamma=0.25, dot_yy=True, dot_xy=True, dot_xx=True)
for gen, (r, c, v, n) in (("banded", banded_random(600, bw=9, density=0.6,
                                                   seed=11)),
                          ("matpde", matpde(24))):
    x = np.random.default_rng(5).standard_normal((n, 3))
    for P in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:P]), ("data",))
        w = [1.0 + (p % 2) for p in range(P)]
        D = dist_from_coo(r, c, v, n, nshards=P, weights=w, C=8, sigma=32,
                          w_align=4, dtype=np.float64)
        for ov in (True, False):
            y, d = dist_spmv(D, mesh, x, opts=opts, overlap=ov, impl="ref")
            out[f"{{gen}}-{{P}}-{{ov}}-y"] = y
            out[f"{{gen}}-{{P}}-{{ov}}-dots"] = d
        eng = HeterogeneousEngine(r, c, v, n, mesh=mesh,
                                  pool=DevicePool.from_bandwidths(w), C=8,
                                  sigma=32, w_align=4, dtype=np.float64)
        y, d = eng.spmv(x, opts=opts, impl="ref")
        out[f"{{gen}}-{{P}}-engine-y"] = y
        out[f"{{gen}}-{{P}}-engine-dots"] = d
        out[f"{{gen}}-{{P}}-engine-ranges"] = np.asarray(eng.plan.ranges)
np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("SUBPROCESS_OK")
"""
OPTS = SpmvOpts(alpha=-1.5, gamma=0.25, dot_yy=True, dot_xy=True,
                dot_xx=True)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    path = str(tmp_path_factory.mktemp("dist_ref") / "ref.npz")
    assert "SUBPROCESS_OK" in run_with_devices(REF_CODE.format(path=path), 4)
    return dict(np.load(path))


def _problem(gen):
    if gen == "banded":
        return banded_random(600, bw=9, density=0.6, seed=11)
    return matpde(24)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("gen", ["banded", "matpde"])
def test_multi_shard_matches_reference_pipeline(ref, gen, P, overlap):
    r, c, v, n = _problem(gen)
    x = np.random.default_rng(5).standard_normal((n, 3))
    w = [1.0 + (p % 2) for p in range(P)]
    D = dist_from_coo(r, c, v, n, nshards=P, devices=["cpu"] * P, weights=w,
                      C=8, sigma=32, w_align=4, dtype=np.float64)
    y, dots = dist_spmv(D, None, x, opts=OPTS, overlap=overlap, impl="ref")
    key = f"{gen}-{P}-{overlap}"
    assert _rel(y, ref[key + "-y"]) <= 1e-12
    np.testing.assert_allclose(dots.numpy(), ref[key + "-dots"], rtol=1e-12)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("gen", ["banded", "matpde"])
def test_multi_shard_engine_matches_reference_engine(ref, gen, P):
    r, c, v, n = _problem(gen)
    x = np.random.default_rng(5).standard_normal((n, 3))
    w = [1.0 + (p % 2) for p in range(P)]
    eng = HeterogeneousEngine(r, c, v, n, devices=["cpu"] * P,
                              pool=DevicePool.from_bandwidths(w), C=8,
                              sigma=32, w_align=4, dtype=np.float64)
    key = f"{gen}-{P}-engine"
    np.testing.assert_array_equal(np.asarray(eng.plan.ranges),
                                  ref[key + "-ranges"])
    y, dots = eng.spmv(x, opts=OPTS, impl="ref")
    assert _rel(y, ref[key + "-y"]) <= 1e-12
    np.testing.assert_allclose(dots.numpy(), ref[key + "-dots"], rtol=1e-12)
    y2, _ = eng.spmv(x, opts=OPTS)              # impl=None: plain on the host
    assert torch.equal(y, y2)


# ------------------------------------------------------------- on the card
def _card_vs_host(devices, nvecs=2, dtype=np.float64):
    r, c, v, n = banded_random(3000, bw=12, density=0.6, seed=8)
    w = [1.0 + (p % 2) for p in range(len(devices))]
    kw = dict(nshards=len(devices), weights=w, C=32, sigma=64, w_align=4,
              dtype=dtype)
    H = dist_from_coo(r, c, v, n, devices=["cpu"] * len(devices), **kw)
    G = dist_from_coo(r, c, v, n, devices=devices, **kw)
    x = np.random.default_rng(3).standard_normal((n, nvecs)).astype(dtype)
    return H, G, x


@pytest.mark.gpu
@pytest.mark.parametrize("devices", [["cuda"] * 2, ["cuda"] * 4,
                                     ["cuda", "cpu"], ["cpu", "cuda", "cpu"]])
def test_card_shards_match_host_shards(devices):
    """Card shards launch B1 on every local part and every non-empty
    remote part; the result is the host split's within 1e-12 of max|y|,
    and overlap equals no overlap bit for bit."""
    need_card()
    H, G, x = _card_vs_host(devices)
    opts = SpmvOpts(alpha=2.0, gamma=0.5, dot_yy=True, dot_xx=True)
    yh, dh = dist_spmv(H, None, x, opts=opts)
    execution.reset_launch_counts()
    yg, dg = dist_spmv(G, None, x, opts=opts, overlap=True)
    torch.cuda.synchronize()
    want = sum(1 + (s.remote.nnz > 0) for s in G.shards
               if s.device.type == "cuda")
    assert execution.launch_counts()["sellcs_spmv"] == want
    assert yg.device.type == "cuda" and dg.device.type == "cuda"
    assert _rel(yg, yh.numpy()) <= 1e-12
    np.testing.assert_allclose(dg.cpu().numpy(), dh.numpy(), rtol=1e-12)
    yn, _ = dist_spmv(G, None, x, opts=opts, overlap=False)
    assert torch.equal(yg, yn)
    # complex values on two card shards: B1 on each, against the plain
    # one-device SpMV of the same matrix
    r, c, v = banded_random(300, bw=3, seed=1)[:3]
    cv = v * np.exp(1j * np.random.default_rng(4).uniform(0, 6.3, v.size))
    Gc = dist_from_coo(r, c, cv, 300, nshards=2, devices=["cuda", "cuda"],
                       C=32, dtype=np.complex128)
    A1 = from_coo(r, c, cv, (300, 300), C=32, dtype=np.complex128,
                  device="cpu")
    xc = (np.random.default_rng(6).standard_normal((300, 2))
          + 1j * np.random.default_rng(7).standard_normal((300, 2)))
    execution.reset_launch_counts()
    yc, _ = dist_spmv(Gc, None, xc)
    torch.cuda.synchronize()
    assert execution.launch_counts()["sellcs_spmv"] == sum(
        1 + (s.remote.nnz > 0) for s in Gc.shards)
    y1 = A1.unpermute(spmv_ref(A1, A1.permute(torch.from_numpy(xc)))[0])
    assert yc.dtype == torch.complex128
    assert ((yc.cpu() - y1).abs().max() / y1.abs().max()).item() <= 1e-12


@pytest.mark.gpu
def test_card_engine_against_one_device_b1():
    """An engine over 2 and 4 card shards and over the host plus the card
    against the one-device B1 SpMV of the same matrix."""
    need_card()
    from repro_torch.kernels.ops import sellcs_spmv
    r, c, v, n = banded_random(5000, bw=20, density=0.8, seed=3)
    A1 = from_coo(r, c, v, (n, n), C=32, sigma=256, dtype=np.float64,
                  device="cuda")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((n, 4)))
    y1 = A1.unpermute(sellcs_spmv(A1, A1.permute(x.cuda()))[0])
    for devices in (["cuda"] * 2, ["cuda"] * 4, ["cuda", "cpu"]):
        eng = HeterogeneousEngine(r, c, v, n, devices=devices, C=32,
                                  sigma=256, dtype=np.float64)
        y_ov, _ = eng.spmv(x, overlap=True)
        y_no, _ = eng.spmv(x, overlap=False)
        assert _rel(y_ov, y1.cpu().numpy()) <= 1e-12
        assert torch.equal(y_ov, y_no)


def _delay_h2d(monkeypatch, cycles):
    """Make every copy onto the card wait ``cycles`` on its stream first,
    so the copies that read a host slot are still in flight when the
    next call comes."""
    real = tdist.halo_exchange

    def slow(A, p, stacks, side=None):
        if A.shards[p].device.type == "cuda":
            torch.cuda._sleep(cycles)
        real(A, p, stacks, side)

    monkeypatch.setattr(tdist, "halo_exchange", slow)


@pytest.mark.gpu
@pytest.mark.parametrize("double_buffer", [False, True])
def test_slots_under_asynchronous_copies(monkeypatch, double_buffer):
    """A chain on the host plus the card, with every copy onto the card
    held back ~50 ms: the host would rewrite its slot while the copy still
    reads it, but ``Staging.take`` waits on the copy's event, so the chain
    equals the undelayed one bit for bit.  Without that wait (the control)
    the chain goes wrong, which shows the events are load-bearing."""
    need_card()
    H, G, x = _card_vs_host(["cpu", "cuda"], nvecs=1)
    cycles = int(50e-3 * 1.5e9)            # tens of ms at the card's clock

    def chain():
        run = make_pipeline_spmv(G, nvecs=1, double_buffer=double_buffer)
        w, stg = G.distribute_vec(x), None
        for _ in range(4):
            w, _, stg = run(w, staging=stg)
        torch.cuda.synchronize()
        return [t.cpu() for t in w]

    want = chain()
    _delay_h2d(monkeypatch, cycles)
    got = chain()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if not double_buffer:
        def take_without_waiting(self):
            self.calls += 1
            return (self.calls - 1) % self.slots

        monkeypatch.setattr(Staging, "take", take_without_waiting)
        bad = chain()
        assert not all(torch.equal(a, b) for a, b in zip(bad, want))

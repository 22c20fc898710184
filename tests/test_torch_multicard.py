"""The distributed SELL-C-sigma SpMV with its shards on several cards.

On the CPU:

* the halo exchange's block copies (``distributed.exchange_copies``),
  keyed by integers that stand for cards, applied to one CPU stack per
  key: every shard's unpacked halo equals the JAX package's
  ``halo_exchange_unpack`` (``lax.all_to_all`` on 4 forced host devices)
  exactly, each copy moves the rows the reference's halo takes from that
  sender, and a pair on one key or with nothing to send has no copy — 4
  shards as if on 3 cards plus the host, as if on 4 cards, and all on
  one;
* ``HeterogeneousEngine.on`` moves the matrix and keeps the plan;
* a rehearsal of ``chip_smoke.py``'s phase 15i (host devices standing in
  for cards), and its line when there are fewer than two cards.

The ``gpu``-marked tests skip unless the machine has two cards or more
(four for the 4-card cases): 2 and 4 cards, and 2 cards plus the host,
against the same shards all on ``cuda:0`` (bit for bit without the host,
within 1e-12 of max|y| with it), B1's launches, overlap against no
overlap and the double-buffered chain against the unbuffered one under
delayed copies between cards, CG through ``DistOperator`` with one
card's iterations, and an engine-backed ``SolverService`` drain over the
default engine (one shard a card).
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import REPO, run_with_devices

from repro_torch.core import SpmvOpts, execution
from repro_torch.core.distributed import (dist_from_coo, exchange_copies,
                                          halo_pack, halo_unpack)
from repro_torch.matrices import banded_random, laplace3d, matpde
from repro_torch.runtime import (DevicePool, HeterogeneousEngine,
                                 MatrixRegistry, SolverService)
from repro_torch.runtime.pipeline import make_pipeline_spmv
from repro_torch.solvers import cg


def _rel(got, want):
    got = got.cpu().double().numpy()
    want = want.cpu().double().numpy()
    return np.abs(got - want).max() / np.abs(want).max()


# ------------------------------------------ the copy list vs all_to_all
PROBLEMS = {
    "banded": (lambda: banded_random(600, bw=9, density=0.6, seed=11),
               dict(weights=[1.0, 2.0, 1.0, 2.0], C=8, sigma=32, w_align=4)),
    "matpde": (lambda: matpde(24), dict(by_nnz=True, C=8, sigma=16)),
}
LAYOUTS = {
    "3 cards + host": [0, 1, 1, "cpu"],
    "4 cards": [0, 1, 2, 3],
    "one card": [0, 0, 0, 0],
}
NVECS = 2

REF_CODE = """
import numpy as np, jax
jax.config.update("jax_enable_x64", True)
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import distributed as jdist
from repro.matrices import banded_random, matpde

problems = {{
    "banded": (banded_random(600, bw=9, density=0.6, seed=11),
               dict(weights=[1.0, 2.0, 1.0, 2.0], C=8, sigma=32, w_align=4)),
    "matpde": (matpde(24), dict(by_nnz=True, C=8, sigma=16)),
}}
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
out = {{}}
for name, ((r, c, v, n), kw) in problems.items():
    D = jdist.dist_from_coo(r, c, v, n, nshards=4, dtype=np.float64, **kw)
    x = np.random.default_rng(7).standard_normal((n, {nvecs}))
    xs = D.distribute_vec(jax.numpy.asarray(x))
    sh = jdist._shard_view(D)
    spec = {{k: P("data", *([None] * (a.ndim - 1))) for k, a in sh.items()}}

    def fn(shard, x):
        shard = {{k: a[0] for k, a in shard.items()}}
        send = jdist.halo_pack(shard, x[0])
        return jdist.halo_exchange_unpack(D, shard, send, "data")[None]

    halos = jax.jit(jdist.shard_map(
        fn, mesh=mesh, in_specs=(spec, P("data", None, None)),
        out_specs=P("data", None, None)))(sh, xs)
    out[name + "-halo"] = np.asarray(halos)
    out[name + "-halo_idx"] = np.asarray(D.halo_idx)
np.savez({path!r}, **out)
print("SUBPROCESS_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    path = str(tmp_path_factory.mktemp("multicard_ref") / "ref.npz")
    code = REF_CODE.format(path=path, nvecs=NVECS)
    assert "SUBPROCESS_OK" in run_with_devices(code, 4)
    return dict(np.load(path))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_copies_reproduce_the_reference_all_to_all(ref, problem, layout):
    keys = LAYOUTS[layout]
    make, kw = PROBLEMS[problem]
    r, c, v, n = make()
    D = dist_from_coo(r, c, v, n, nshards=4, devices=["cpu"] * 4,
                      dtype=np.float64, **kw)
    P, mm = D.nshards, D.max_msg
    x = np.random.default_rng(7).standard_normal((n, NVECS))
    xs = D.distribute_vec(x)
    rows = P * P * mm + 1
    stacks = {k: torch.zeros((rows, NVECS), dtype=torch.float64)
              for k in set(keys)}
    for q in range(P):
        halo_pack(D, q, xs[q], stacks[keys[q]])
    copies = exchange_copies(D.msg_len, mm, keys)
    for q, p, at, cnt in copies:
        stacks[keys[p]][at:at + cnt] = stacks[keys[q]][at:at + cnt]
    want = ref[problem + "-halo"]
    halo_idx = ref[problem + "-halo_idx"]
    for p, s in enumerate(D.shards):
        h = s.nhalo
        got = halo_unpack(D, p, stacks[keys[p]])
        np.testing.assert_array_equal(got[:h].numpy(), want[p, :h])
        assert not got[h:].any()
    # each copy moves what the reference's halo takes from that sender,
    # and only pairs on two keys with something to send have one
    sent = {(q, p): int((halo_idx[p, :D.shards[p].nhalo] // mm == q).sum())
            for p in range(P) for q in range(P)}
    assert [(q, p) for q, p, _, _ in copies] == [
        (q, p) for p in range(P) for q in range(P)
        if keys[q] != keys[p] and sent[q, p] > 0]
    for q, p, at, cnt in copies:
        assert cnt == sent[q, p] == D.msg_len[q, p]
        assert at == (q * P + p) * mm
    assert any(sent.values())
    if layout == "one card":
        assert copies == []


def test_copy_list_of_a_placement():
    """``DistSellCS.copies`` is the list keyed by the shards' devices:
    empty with every shard on the host; by destination, then source."""
    r, c, v, n = banded_random(600, bw=9, density=0.6, seed=11)
    D = dist_from_coo(r, c, v, n, nshards=4, devices=["cpu"] * 4, C=8)
    assert D.copies == [] and D.home == torch.device("cpu")
    assert D.cards == ()
    keys = ["a", "b", "a", "c"]
    copies = exchange_copies(D.msg_len, D.max_msg, keys)
    order = [(p, q) for q, p, _, _ in copies]
    assert order == sorted(order) and len(copies) > 0
    assert all(keys[q] != keys[p] for q, p, _, _ in copies)


def test_engine_on_moves_the_matrix_and_keeps_the_plan():
    r, c, v, n = matpde(16)
    eng = HeterogeneousEngine(r, c, v, n, devices=["cpu"] * 3, C=8,
                              dtype=np.float64,
                              pool=DevicePool.from_bandwidths([1, 2, 1]))
    x = np.random.default_rng(0).standard_normal((n, 2))
    opts = SpmvOpts(dot_yy=True)
    y, d = eng.spmv(x, opts=opts)
    moved = eng.on(["cpu"] * 3)
    assert moved is not eng and moved.plan is eng.plan
    assert moved.A is eng.A and moved._matvec_cache == {}
    y2, d2 = moved.spmv(x, opts=opts)
    assert torch.equal(y, y2) and torch.equal(d, d2)
    with pytest.raises(ValueError, match="expected 3 devices"):
        eng.on(["cpu"] * 2)


def test_chip_smoke_cross_card_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's phase 15i on the CPU with the ``smoke`` workload:
    with fewer than two devices it says that it did not run; with four
    and with two host devices standing in for cards it runs its gates
    and control flow (the plain version stands in for B1, so the launch
    counts are 0)."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    for name, value in (("DEVICE", "cpu"), ("MLGEER", "smoke"),
                        ("REBALANCE_CALLS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    mlg = chip_smoke.phase_mlgeer("cpu rehearsal")
    r, c, v, n = laplace3d(10)
    fw = {"coo": (r, c, v, n), "solve_s": {"f64": 1.0}, "iters64": 1,
          "A64": chip_smoke.from_coo(r, c, v, (n, n), C=32, sigma=1024,
                                     dtype=np.float64, device="cpu"),
          "b_host": np.random.default_rng(0).standard_normal((n, 4))}
    ecg = chip_smoke.phase_engine_cg(fw, "cpu rehearsal")
    monkeypatch.setattr(chip_smoke, "CROSS_REHEARSAL", 1)
    out = chip_smoke.phase_cross_cards(mlg, ecg, fw, "cpu rehearsal")
    assert out == {"ran": False, "launches": 0}
    for k in (chip_smoke.ENGINE_SHARDS, 2):
        monkeypatch.setattr(chip_smoke, "CROSS_REHEARSAL", k)
        out = chip_smoke.phase_cross_cards(mlg, ecg, fw, "cpu rehearsal")
        assert out["ran"] and out["launches"] == 0
        assert out["cg_iters"] == ecg[f"{chip_smoke.ENGINE_SHARDS} card "
                                      f"shards"]["iters"] or k == 2
        assert set(out["ms"]) == {True, False} and out["host_ms"] > 0
        assert out["split_join_bytes"] == 0       # nothing leaves the host
    # the bytes it prints, on shards relabelled as if on two cards and the
    # host: halo copies between the cards only, and every slice off
    # cuda:0 out and back
    A = mlg["keep"]["eng"].A
    devs = [torch.device(d) for d in ("cuda:0", "cuda:1", "cuda:1", "cpu")]
    placed = dataclasses.replace(A, shards=tuple(
        dataclasses.replace(s, device=d) for s, d in zip(A.shards, devs)))
    b = 3
    halo, split = chip_smoke._between_cards(placed, b)
    between = [(q, p) for q, p in ((0, 1), (0, 2), (1, 0), (2, 0))]
    assert halo == sum(int(A.msg_len[q, p]) for q, p in between) * b * 8
    assert halo > 0
    assert split == 2 * sum(s.nrows_pad for s in A.shards[1:]) * b * 8


# ------------------------------------------------------------ on the cards
def need_cards(k):
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < k:
        pytest.skip(f"needs {k} NVIDIA GPUs, the machine has {count}")


PLACEMENTS = {
    "2 cards": (2, ["cuda:0", "cuda:0", "cuda:1", "cuda:1"]),
    "4 cards": (4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    "2 cards + host": (2, ["cuda:0", "cuda:1", "cpu"]),
}


def _placed(devices, n=4000, nvecs=3):
    r, c, v, n = banded_random(n, bw=12, density=0.6, seed=8)
    P = len(devices)
    kw = dict(nshards=P, weights=[1.0 + (p % 2) for p in range(P)], C=32,
              sigma=64, w_align=4, dtype=np.float64)
    one = dist_from_coo(r, c, v, n, devices=["cuda:0"] * P, **kw)
    x = np.random.default_rng(3).standard_normal((n, nvecs))
    return one, one.on(devices), x


@pytest.mark.gpu
@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_cards_against_one_card(placement):
    """y and the dots equal those of the same shards all on ``cuda:0``,
    bit for bit without the host and within 1e-12 of max|y| with it; B1
    launched once per card shard and once more per non-empty remote part;
    overlap equals no overlap, and the double-buffered chain the
    unbuffered one, bit for bit."""
    ncards, devices = PLACEMENTS[placement]
    need_cards(ncards)
    from repro_torch.core.distributed import dist_spmv
    one, many, x = _placed(devices)
    assert many.home == torch.device("cuda:0")
    assert len(many.cards) == ncards and len(many.copies) > 0
    opts = SpmvOpts(alpha=2.0, gamma=0.5, dot_yy=True, dot_xy=True,
                    dot_xx=True)
    y1, d1 = dist_spmv(one, None, x, opts=opts)
    execution.reset_launch_counts()
    y, d = dist_spmv(many, None, x, opts=opts, overlap=True)
    for i in range(ncards):
        torch.cuda.synchronize(i)
    want = sum(1 + (s.remote.nnz > 0) for s in many.shards
               if s.device.type == "cuda")
    assert execution.launch_counts()["sellcs_spmv"] == want
    assert y.device == d.device == torch.device("cuda:0")
    if "cpu" in devices:
        assert _rel(y, y1) <= 1e-12
        np.testing.assert_allclose(d.cpu().numpy(), d1.cpu().numpy(),
                                   rtol=1e-12)
    else:
        assert torch.equal(y, y1) and torch.equal(d, d1)
    yn, dn = dist_spmv(many, None, x, opts=opts, overlap=False)
    assert torch.equal(y, yn) and torch.equal(d, dn)
    xs = many.distribute_vec(x)
    run_db = make_pipeline_spmv(many, nvecs=x.shape[1], double_buffer=True)
    run_nb = make_pipeline_spmv(many, nvecs=x.shape[1])
    w, w2, stg = xs, xs, None
    for _ in range(4):
        w, _, stg = run_db(w, staging=stg)
        w2, _, _ = run_nb(w2)
    assert all(torch.equal(a, b) for a, b in zip(w, w2))


@pytest.mark.gpu
@pytest.mark.parametrize("double_buffer", [False, True])
def test_chain_under_delayed_copies_between_cards(monkeypatch,
                                                  double_buffer):
    """Every exchange into a card held back ~20 ms on its side stream: a
    copy between two cards then waits for it (its barrier against the
    destination's stream), and the next call's pack on the source card
    waits for the copy, so the chain equals the undelayed one bit for
    bit."""
    need_cards(2)
    from repro_torch.core import distributed as tdist
    _, many, x = _placed(PLACEMENTS["2 cards"][1], nvecs=1)
    cycles = int(20e-3 * 1.5e9)

    def chain():
        run = make_pipeline_spmv(many, nvecs=1, double_buffer=double_buffer)
        w, stg = many.distribute_vec(x), None
        for _ in range(4):
            w, _, stg = run(w, staging=stg)
        for i in range(2):
            torch.cuda.synchronize(i)
        return [t.cpu() for t in w]

    want = chain()
    real = tdist.halo_exchange

    def slow(A, p, stacks, side=None):
        torch.cuda._sleep(cycles)
        real(A, p, stacks, side)

    monkeypatch.setattr(tdist, "halo_exchange", slow)
    got = chain()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_cg_across_cards_takes_one_cards_iterations():
    """CG through DistOperator with one shard on each of (up to) four
    cards: the iterations and the solution of the same shards on one
    card, bit for bit."""
    need_cards(2)
    k = min(4, torch.cuda.device_count())
    r, c, v, n = laplace3d(24)
    eng = HeterogeneousEngine(r, c, v, n, devices=["cuda:0"] * k, C=32,
                              sigma=64, dtype=np.float64)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal((n, 2)))
    res = {}
    for key, e in (("one", eng), ("many", eng.on(
            [f"cuda:{i}" for i in range(k)]))):
        op = e.operator()
        assert op.device == torch.device("cuda:0")
        out = cg(op, op.to_op_space(b.to(op.device)), tol=1e-10,
                 maxiter=600)
        res[key] = (out.iters, op.from_op_space(out.x))
        assert bool(out.converged.all())
    assert res["one"][0] == res["many"][0]
    assert torch.equal(res["one"][1], res["many"][1])


@pytest.mark.gpu
def test_default_engine_serves_across_cards():
    """``HeterogeneousEngine`` without devices puts one shard on each
    card; registered in a ``MatrixRegistry`` it drains CG requests
    through B1, every one converged."""
    need_cards(2)
    r, c, v, n = laplace3d(12)
    eng = HeterogeneousEngine(r, c, v, n, C=32, sigma=64, dtype=np.float64)
    count = torch.cuda.device_count()
    assert eng.nshards == count
    assert eng.A.cards == tuple(torch.device("cuda", i)
                                for i in range(count))
    reg = MatrixRegistry()
    reg.register("dist", eng)
    svc = SolverService(reg, block_width=2, chunk_iters=8)
    execution.reset_launch_counts()
    rng = np.random.default_rng(5)
    tickets = [svc.submit("dist", rng.standard_normal(n), solver="cg",
                          tol=1e-8, maxiter=600,
                          precond=None if i % 2 else "chebyshev:3")
               for i in range(4)]
    svc.drain()
    assert execution.launch_counts()["sellcs_spmv"] > 0
    Ad = np.zeros((n, n))
    np.add.at(Ad, (r, c), v)
    for t in tickets:
        assert t.status == "done" and t.result.converged
        res = Ad @ t.result.x - t.b
        assert np.linalg.norm(res) / np.linalg.norm(t.b) < 1e-6

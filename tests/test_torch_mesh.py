"""Placement on a mesh of ranks: ``launch.mesh`` (``init_ranks``,
``make_host_mesh``, ``Mesh.of``), ``models.sharding`` (``shard_index``,
``shard``, ``gather``) and ``data.pipeline.make_global_batch``, against
the JAX package on the CPU.

* ``shard_index`` equals JAX's ``NamedSharding(mesh, spec)
  .devices_indices_map(shape)`` for every device, exactly: every
  parameter leaf, every AdamW and Adafactor slot and the batch of the
  SMOKE configs of qwen2.5-3b, jamba-1.5-large and grok-1, on meshes
  (2, 2), (4, 1) and (1, 4) of 4 forced host devices, under all three
  layouts.  The port takes its own specs (``tests/test_torch_sharding.py``
  holds them equal to the JAX package's); the JAX mesh puts device ``i *
  model + j`` at ``(i, j)``, as ``make_host_mesh`` puts rank ``i * model
  + j``.
* ``make_global_batch`` gives each coordinate exactly the rows the JAX
  package's gives that device, global batches 4, 2 and 6 (some of them
  replicated by the guard).
* On 4 ``gloo`` ranks: ``make_host_mesh``'s layout, and ``shard`` then
  ``gather`` give back each leaf bit for bit, tuple entries included.
"""
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import torch_ranks as R
from conftest import SRC
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import make_global_batch
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T

ARCHS = ("qwen2_5_3b", "jamba_1_5_large_398b", "grok_1_314b")
LAYOUTS = ("tp", "fsdp", "zero1")
SHAPES = ((2, 2), (4, 1), (1, 4))
BATCHES = (4, 2, 6)
SEQ = 8
GRID = [(a, lay, m) for a in ARCHS for lay in LAYOUTS for m in SHAPES]

REF_CODE = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_smoke_config
from repro.data.pipeline import make_global_batch
from repro.models import sharding as SH
from repro.models import transformer as T
from repro.train import optimizer as OPT
archs, layouts, shapes, batches, seq = eval(sys.argv[1])

def flat(tree, is_spec=False):
    kw = {"is_leaf": lambda x: isinstance(x, SH.P)} if is_spec else {}
    return {"/".join(SH._path_names(p)): v
            for p, v in jax.tree_util.tree_leaves_with_path(tree, **kw)}

def index_map(spec, shape, mesh):
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    return {d.id: tuple((s.start, s.stop) for s in idx)
            for d, idx in m.items()}

out = {"index": {}, "rows": {}}
for d, m in shapes:
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))
    for layout in layouts:
        SH.set_layout(layout)
        for arch in archs:
            cfg = get_smoke_config(arch)
            jp = jax.eval_shape(lambda: T.init_params(cfg,
                                                      jax.random.PRNGKey(0)))
            ps = SH.param_specs(cfg, jp, mesh)
            trees = {"p": (jp, ps)}
            for kind in ("adamw", "adafactor"):
                o = jax.eval_shape(lambda: OPT.make_optimizer(kind).init(jp))
                trees[kind] = (o, SH.opt_specs(ps, o, mesh))
            shp = {"tokens": jax.ShapeDtypeStruct((4, seq), jnp.int32)}
            trees["batch"] = (shp, SH.batch_specs(cfg, shp, mesh))
            res = {}
            for group, (tree, specs) in trees.items():
                leaves, specs = flat(tree), flat(specs, True)
                for path, leaf in leaves.items():
                    res[f"{group}:{path}"] = (tuple(leaf.shape),
                                              index_map(specs[path],
                                                        leaf.shape, mesh))
            out["index"][(arch, layout, (d, m))] = res
        cfg = get_smoke_config("qwen2_5_3b")
        for gb in batches:
            host = {"tokens": np.arange(gb * seq, dtype=np.int32
                                        ).reshape(gb, seq)}
            specs = SH.batch_specs(cfg, {"tokens": jax.ShapeDtypeStruct(
                (gb, seq), jnp.int32)}, mesh)
            arr = make_global_batch(host, mesh, specs)["tokens"]
            out["rows"][(layout, (d, m), gb)] = {
                s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    SH.set_layout("tp")
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("SUBPROCESS_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's index maps and batch rows, once (4 forced host
    devices, in a subprocess)."""
    pytest.importorskip("jax")
    path = tmp_path_factory.mktemp("mesh_ref") / "ref.pkl"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC)
    args = repr((ARCHS, LAYOUTS, SHAPES, BATCHES, SEQ))
    out = subprocess.run([sys.executable, "-c", REF_CODE, args, str(path)],
                         env=env, capture_output=True, text=True, timeout=500)
    assert out.returncode == 0 and "SUBPROCESS_OK" in out.stdout, \
        out.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _port_leaves(arch, mesh):
    """The port's leaves and specs of one SMOKE config: ``{"group:path":
    (leaf, spec)}``."""
    cfg = get_smoke_config(arch)
    params = DR.param_leaves(T.init_params(cfg, device="meta"))
    ps = SH.param_specs(cfg, params, mesh)
    out = {f"p:{k}": (v, ps[k]) for k, v in params.items()}
    for kind in ("adamw", "adafactor"):
        o = DR.opt_leaves(kind, params)
        os_ = SH.opt_specs(ps, o, mesh)
        out.update({f"{kind}:{k}": (v, os_[k]) for k, v in o.items()})
    batch = {"tokens": torch.empty((4, SEQ), dtype=torch.int32,
                                   device="meta")}
    bs = SH.batch_specs(cfg, batch, mesh)
    out["batch:tokens"] = (batch["tokens"], bs["tokens"])
    return out


def _coord(dev, shape):
    return (dev // shape[1], dev % shape[1])


def _as_pairs(idx):
    return tuple((s.start, s.stop) for s in idx)


@pytest.mark.parametrize("arch,layout,shape", GRID,
                         ids=[f"{a}-{lay}-{d}x{m}" for a, lay, (d, m) in GRID])
def test_shard_index_matches_jax(ref, arch, layout, shape):
    want = ref["index"][(arch, layout, shape)]
    mesh = M.Mesh({"data": shape[0], "model": shape[1]})
    SH.set_layout(layout)
    try:
        leaves = _port_leaves(arch, mesh)
    finally:
        SH.set_layout("tp")
    assert sorted(leaves) == sorted(want)
    for path, (leaf, spec) in leaves.items():
        wshape, wmap = want[path]
        assert tuple(leaf.shape) == wshape, path
        for dev, widx in wmap.items():
            got = SH.shard_index(spec, leaf.shape, mesh, _coord(dev, shape))
            assert _as_pairs(got) == widx, (path, dev, spec)


class _StandIn:
    """What ``make_global_batch`` reads of a ``DeviceMesh``: the dim names
    and sizes and this rank's coordinate."""

    def __init__(self, shape, coord):
        self.mesh_dim_names = ("data", "model")
        self.mesh = types.SimpleNamespace(shape=shape)
        self.coord = coord

    def get_coordinate(self):
        return list(self.coord)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("gb", BATCHES)
def test_make_global_batch_rows_match_jax(ref, layout, shape, gb):
    want = ref["rows"][(layout, shape, gb)]
    host = {"tokens": np.arange(gb * SEQ, dtype=np.int32).reshape(gb, SEQ)}
    view = M.Mesh({"data": shape[0], "model": shape[1]})
    SH.set_layout(layout)
    try:
        specs = SH.batch_specs(None, host, view)
    finally:
        SH.set_layout("tp")
    for dev, rows in want.items():
        got = make_global_batch(host, _StandIn(shape, _coord(dev, shape)),
                                specs, "cpu")["tokens"]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), rows)


def test_shard_index_rejects_what_does_not_divide():
    mesh = M.Mesh({"data": 2, "model": 2})
    with pytest.raises(ValueError, match="does not divide"):
        SH.shard_index((("data", "model"),), (6,), mesh, (0, 1))
    with pytest.raises(ValueError, match="more entries"):
        SH.shard_index(("data", None), (6,), mesh, (0, 1))
    assert SH.shard_index((), (6, 2), mesh, (1, 1)) == (slice(None),) * 2


# ------------------------------------------------------------------ ranks
RANK_SPECS = {
    (2, 2): {"a": (("data", "model"), None, None),
             "b": (None, "data", "model"),
             "c": ("model", None, "data"),
             "d": (None, ("model", "data"), None),
             "v": ()},
    (4, 1): {"a": ("data", None, None), "b": (None, None, ("data", "model")),
             "c": (None, None, None), "d": ("model", "data", None),
             "v": ("data",)},
    (1, 4): {"a": (None, "model", None), "b": (("data", "model"), None, None),
             "c": ("model",), "d": (None, None, "model"), "v": ("model",)},
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(3)
    arrays = {k: rng.standard_normal((8, 4, 12)) for k in "abcd"}
    arrays["v"] = np.arange(8, dtype=np.int64)
    leaves = {"arrays": arrays, "specs": RANK_SPECS}
    return arrays, R.run_ranks(R.mesh_ranks,
                               tmp_path_factory.mktemp("mesh_ranks"), 4,
                               leaves)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_host_mesh_layout_and_round_trip(ranks, shape):
    arrays, out = ranks
    view = M.Mesh({"data": shape[0], "model": shape[1]})
    for rank, res in enumerate(out):
        got = res[shape]
        assert got["coord"] == _coord(rank, shape)
        assert got["view"] == ({"data": shape[0], "model": shape[1]},
                               ("data", "model"))
        assert got["round_trip"]
        for path, spec in RANK_SPECS[shape].items():
            full = arrays[path]
            want = full[SH.shard_index(spec, full.shape, view, got["coord"])]
            np.testing.assert_array_equal(got[path], want.astype(np.float64))


def test_init_ranks_refuses_nccl_on_a_shared_card(monkeypatch, tmp_path):
    """``nccl`` with more ranks on the host than cards raises, naming
    ``gloo``, before any group is joined; without a card, the card is
    refused unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="gloo"):
        M.init_ranks("nccl", init_method=f"file://{tmp_path}/s", rank=0,
                     world_size=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_ranks("gloo", init_method=f"file://{tmp_path}/s", rank=0,
                     world_size=4)
    assert not torch.distributed.is_initialized()


def test_make_host_mesh_needs_the_world(tmp_path):
    """A mesh whose size is not the group's raises (one rank here)."""
    M.init_ranks("gloo", device="cpu", init_method=f"file://{tmp_path}/s",
                 rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            M.make_host_mesh(2, 2, device="cpu")
        mesh = M.make_host_mesh(1, 1, device="cpu")
        assert M.Mesh.of(mesh).shape == {"data": 1, "model": 1}
    finally:
        torch.distributed.destroy_process_group()

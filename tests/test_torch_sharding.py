"""Parity of the port's sharding rules (``models/sharding.py``) with the
JAX package's, leaf for leaf.

Every parameter, optimizer-state, batch and cache spec of the port equals
``tuple(PartitionSpec)`` of the JAX package's for the same leaf, for all
ten architectures (FULL configs: on ``meta`` in the port, through
``jax.eval_shape`` in the JAX package; SMOKE configs too), the three
layouts and both production meshes; the JAX rules get a stand-in mesh
with ``.shape`` and ``.axis_names``, which is all they read.  The bytes
one device holds of each tree under those specs are equal as integers.
Each FULL config's shapes are evaluated once per module, in both
packages.
"""
import pytest

jax = pytest.importorskip("jax")   # the reference package needs JAX

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.models import sharding as JSH  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro_torch.configs import (SHAPES, get_config,  # noqa: E402
                                 get_smoke_config, input_specs, list_archs)
from repro_torch.configs.base import shape_applicable  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import MESHES, make_mesh  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch_jax_trees import (jax_bytes, jax_flat, jax_specs, layout,  # noqa: E402
                             shapes_of, stand_in)

ARCHS = list_archs()
LAYOUTS = ("tp", "fsdp", "zero1")
GRID = [(a, lay, m) for a in ARCHS for lay in LAYOUTS for m in MESHES]
GRID_IDS = [f"{a}-{lay}-{m}" for a, lay, m in GRID]
DECODE = ("decode_32k", "long_500k")


def _trees(jcfg, cfg, kind=None):
    """Parameter and optimizer leaves of one config in both packages."""
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = DR.param_leaves(T.init_params(cfg, device="meta"))
    n = sum(x.size for x in jax.tree.leaves(jp))
    kind = kind or DR.pick_optimizer(n)
    jo = jax.eval_shape(lambda: JOPT.make_optimizer(kind).init(jp))
    return dict(jp=jp, tp=tp, jo=jo, to=DR.opt_leaves(kind, tp), kind=kind)


@pytest.fixture(scope="module")
def full():
    """Each FULL config's parameter, optimizer and decode-cache shapes,
    once, in both packages."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        t = _trees(jcfg, cfg)
        for shape in DECODE:
            if not shape_applicable(cfg, SHAPES[shape])[0]:
                continue
            B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
            t[shape] = (jax.eval_shape(lambda: JT.init_cache(jcfg, B, S)),
                        DR.cache_leaves(cfg, B, S))
        out[arch] = t
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_equal_reference(full, arch):
    """The port's leaf paths, shapes and dtypes are the JAX package's:
    parameters stacked over periods, the optimizer state, the caches."""
    t = full[arch]
    assert shapes_of(t["tp"]) == shapes_of(jax_flat(t["jp"]))
    assert shapes_of(t["to"]) == shapes_of(jax_flat(t["jo"]))
    for shape in DECODE:
        if shape in t:
            jc, tc = t[shape]
            assert shapes_of(tc) == shapes_of(jax_flat(jc)), shape


@pytest.mark.parametrize("arch,lay,mesh_name", GRID, ids=GRID_IDS)
def test_param_and_opt_specs(full, arch, lay, mesh_name):
    t = full[arch]
    mesh, jmesh = make_mesh(mesh_name), stand_in(mesh_name)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    with layout(lay):
        jps = JSH.param_specs(jcfg, t["jp"], jmesh)
        ps = SH.param_specs(cfg, t["tp"], mesh)
        assert ps == jax_specs(jps)
        jos = JSH.opt_specs(jps, t["jo"], jmesh)
        os_ = SH.opt_specs(ps, t["to"], mesh)
        assert os_ == jax_specs(jos)
    assert SH.shard_bytes(t["tp"], ps, mesh) == \
        jax_bytes(jax_flat(t["jp"]), jax_specs(jps), mesh)
    assert SH.shard_bytes(t["to"], os_, mesh) == \
        jax_bytes(jax_flat(t["jo"]), jax_specs(jos), mesh)


@pytest.mark.parametrize("arch,lay,mesh_name", GRID, ids=GRID_IDS)
def test_cache_specs(full, arch, lay, mesh_name):
    """decode_32k (batch sharded) and, for the sub-quadratic models,
    long_500k (context parallelism: ``seq_shard``), and each cache the
    other way too."""
    t = full[arch]
    mesh, jmesh = make_mesh(mesh_name), stand_in(mesh_name)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    seen = 0
    with layout(lay):
        for shape in DECODE:
            if shape not in t:
                continue
            jc, tc = t[shape]
            for seq_shard in (shape == "long_500k", shape != "long_500k"):
                want = jax_specs(JSH.cache_specs(jcfg, jc, jmesh,
                                                 seq_shard=seq_shard))
                got = SH.cache_specs(cfg, tc, mesh, seq_shard=seq_shard)
                assert got == want, (shape, seq_shard)
                assert SH.shard_bytes(tc, got, mesh) == \
                    jax_bytes(jax_flat(jc), want, mesh)
                seen += 1
    assert seen == (4 if cfg.sub_quadratic else 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs(arch):
    """Every cell's batch (the port's ``input_specs`` against the JAX
    package's) and the dry run's decode tokens and encoder states, all
    layouts and meshes."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for lay in LAYOUTS:
        for mesh_name in MESHES:
            mesh, jmesh = make_mesh(mesh_name), stand_in(mesh_name)
            with layout(lay):
                for name, shape in SHAPES.items():
                    if not shape_applicable(cfg, shape)[0]:
                        continue
                    jb = jax_input_specs(jcfg, JSHAPES[name])
                    tb = input_specs(cfg, shape)
                    assert SH.batch_specs(cfg, tb, mesh) == \
                        jax_specs(JSH.batch_specs(jcfg, jb, jmesh))
                    B, S = shape.global_batch, shape.seq_len
                    dp, jdp = SH.dp_axes(mesh), JSH.dp_axes(jmesh)
                    assert dp == jdp
                    for shp in ((B, 1), (B, S, cfg.d_model)):
                        want = JSH.guard_spec(
                            JSH.P(jdp, *([None] * (len(shp) - 1))), shp,
                            jmesh)
                        assert SH.guard_spec(
                            (dp,) + (None,) * (len(shp) - 1), shp,
                            mesh) == tuple(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_specs(arch):
    """The SMOKE configs (the JAX package's own spec test runs them):
    parameter and AdamW/Adafactor specs, all layouts and meshes."""
    for kind in ("adamw", "adafactor"):
        t = _trees(jax_get_smoke(arch), get_smoke_config(arch), kind)
        for lay in LAYOUTS:
            for mesh_name in MESHES:
                mesh, jmesh = make_mesh(mesh_name), stand_in(mesh_name)
                with layout(lay):
                    jps = JSH.param_specs(jax_get_smoke(arch), t["jp"],
                                          jmesh)
                    ps = SH.param_specs(get_smoke_config(arch), t["tp"],
                                        mesh)
                    assert ps == jax_specs(jps)
                    assert SH.opt_specs(ps, t["to"], mesh) == \
                        jax_specs(JSH.opt_specs(jps, t["jo"], jmesh))


def test_guard_spec_and_entries():
    """Entries normalise as ``PartitionSpec``'s (a one-name tuple is the
    name, an empty tuple None); a dim that an axis does not divide is
    replicated; a short spec is padded and a long one cut."""
    jmesh, mesh = stand_in("multi"), make_mesh("multi")
    cases = [((("data",), None), (32, 5)),
             ((("pod", "data"), "model"), (64, 48)),
             (((), "model"), (3, 24)),
             (("model",), (16, 7, 9)),
             (("data", "model", None), (16,)),
             ((("pod", "data", "model"), None), (512, 1))]
    for spec, shape in cases:
        want = tuple(JSH.guard_spec(JSH.P(*spec), shape, jmesh))
        assert SH.guard_spec(spec, shape, mesh) == want, (spec, shape)
    for lay in LAYOUTS:
        with layout(lay):
            assert SH.dp_axes(mesh) == JSH.dp_axes(jmesh)
            assert SH.get_layout() == JSH.get_layout() == lay
    with pytest.raises(ValueError, match="unknown layout"):
        SH.set_layout("pp")
    assert SH.get_layout() == "tp"


def test_flatten_paths():
    """Nested dicts, lists and tuples flatten to the JAX package's paths."""
    tree = {"b": [1, (2, 3)], "a": {"x": 4}}
    assert SH.flatten(tree) == {"b/0": 1, "b/1/0": 2, "b/1/1": 3, "a/x": 4}
    assert jax_flat(tree) == {"a/x": 4, "b/0": 1, "b/1/0": 2, "b/1/1": 3}

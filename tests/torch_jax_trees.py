"""The JAX package's pytrees, specs and shard bytes in the port's terms,
for the parity tests of the sharding rules and the dry run: flat
``{path: leaf}`` mappings under the paths the port writes
(``decoder/l0_mix/attn/wq``), specs as tuples, a stand-in mesh with the
``.shape`` and ``.axis_names`` that the JAX rules read, and both
packages' layout set together.  It imports JAX; a test module that also
runs on the card (where JAX is not installed) imports it lazily."""
import contextlib
import types

import jax
import numpy as np
import torch

from repro.models import sharding as JSH
from repro_torch.launch.mesh import MESHES
from repro_torch.models import sharding as SH


def stand_in(mesh_name):
    """What the JAX rules read of a mesh."""
    shape = MESHES[mesh_name]
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


@contextlib.contextmanager
def layout(name):
    JSH.set_layout(name)
    SH.set_layout(name)
    try:
        yield
    finally:
        JSH.set_layout("tp")
        SH.set_layout("tp")


def jax_flat(tree, is_spec=False):
    """``{path: leaf}`` of a JAX tree, paths as the port writes them."""
    kw = {"is_leaf": lambda x: isinstance(x, JSH.P)} if is_spec else {}
    return {"/".join(JSH._path_names(p)): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree, **kw)}


def jax_specs(tree):
    return {k: tuple(s) for k, s in jax_flat(tree, is_spec=True).items()}


def shapes_of(flat):
    return {k: (tuple(v.shape), np.dtype(v.dtype).name
                if not isinstance(v, torch.Tensor) else
                str(v.dtype).replace("torch.", "")) for k, v in flat.items()}


def jax_bytes(flat, specs, mesh):
    """The JAX side's bytes a device holds, from its own specs."""
    total = 0
    for k, leaf in flat.items():
        parts = 1
        for ax in specs[k]:
            for a in (() if ax is None else
                      ax if isinstance(ax, tuple) else (ax,)):
                parts *= mesh.shape[a]
        total += int(np.prod(leaf.shape, dtype=np.int64)) * \
            np.dtype(leaf.dtype).itemsize // parts
    return total

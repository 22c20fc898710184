"""The hardware table of the roofline, the dry run's mesh shapes, and
the ranks and host mesh that training runs on.

The port of ``repro/launch/mesh.py``.  ``HW`` keeps the JAX package's
keys, so the cost model, ``refresh_costs`` and ``roofline`` read the same
fields, with one NVIDIA H100 SXM5's values in place of a TPU's.

The dry run's production meshes are only shapes on one card: a plain
ordered mapping of axis name to size, so ``make_production_mesh`` has no
counterpart.  :class:`Mesh` gives such a mapping the ``.shape``,
``.axis_names`` and ``.size`` that the sharding rules and the dry run
read.

    single  16 x 16 devices  ("data", "model")
    multi   2 x 16 x 16      ("pod", "data", "model")

A mesh that training runs on is made of processes: each mesh position is
one rank of the default ``torch.distributed`` process group
(``torchrun``'s SPMD idiom, one process a device), joined by
:func:`init_ranks`; :func:`make_host_mesh` lays the ranks out as a
``DeviceMesh`` of shape ``(data, model)``, rank ``data_index * model +
model_index`` at each position, as the JAX package's ``make_host_mesh``
lays out ``jax.devices()``.  ``Mesh.of`` is the view of such a mesh that
the sharding rules read.  ``nccl`` takes one card a rank; ranks that
share a card take ``gloo``, which also runs on the CPU.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.execution import resolve_device

__all__ = ["HW", "MESHES", "Mesh", "make_mesh", "init_ranks",
           "make_host_mesh"]


# NVIDIA H100 SXM5 80GB, per card, for the roofline analysis
HW = {
    # NVIDIA's H100 SXM5 datasheet: 1,979 TFLOP/s bf16 with sparsity,
    # halved for dense products
    "peak_flops_bf16": 989e12,
    # measured by chip_smoke.py (phase 15d) on an NVIDIA H100 80GB HBM3 at
    # 700.00 W: the "h100" entry of runtime/devicepool.py
    "hbm_bw": 3032.3e9,
    # NVLink 4, the published 900 GB/s per card (the key keeps the JAX
    # package's name; on this card it is NVLink, not ICI)
    "ici_bw": 900e9,
    # the card's published memory, 80 GB
    "hbm_bytes": 80e9,
}

MESHES: Dict[str, Dict[str, int]] = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}


class Mesh:
    """Axis names and sizes: the part of a JAX mesh that the sharding
    rules read (``.shape[axis]``, ``.axis_names``) and the device count
    (``.size``)."""

    def __init__(self, axes: Mapping[str, int]):
        self.shape: Dict[str, int] = dict(axes)
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.size = math.prod(self.shape.values())

    @classmethod
    def of(cls, device_mesh) -> "Mesh":
        """The axes of a ``DeviceMesh`` (its dim names and sizes)."""
        return cls(dict(zip(device_mesh.mesh_dim_names,
                            device_mesh.mesh.shape)))


def make_mesh(name: str) -> Mesh:
    """The production mesh ``"single"`` (one pod) or ``"multi"`` (two)."""
    return Mesh(MESHES[name])


def init_ranks(backend: str, *, device=None, init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               timeout_s: Optional[float] = None) -> torch.device:
    """Join the default process group and return this rank's device.

    Without ``init_method`` the rank, the world size and the rendezvous
    come from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); with one (a
    ``file://`` store, say) the caller passes ``rank`` and
    ``world_size``.  The device is ``cuda:(LOCAL_RANK % cards)`` (made
    current), or the CPU when ``device`` is ``"cpu"``; without a card and
    without ``device="cpu"`` it raises.  ``backend`` is the caller's
    choice: ``"nccl"`` with more ranks on this host than cards raises
    (NCCL refuses two ranks on one card; such ranks take ``"gloo"``)."""
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if backend == "nccl" and on_host > cards:
            raise ValueError(
                f"backend 'nccl' takes one card a rank: {on_host} ranks on "
                f"{cards} card(s); ranks that share a card take 'gloo'")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return dev


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ``DeviceMesh`` of the default group's ranks, shape ``(data,
    model)``, named ``("data", "model")``: rank ``i * model + j`` at
    ``(i, j)``.  ``device`` is the ranks' device type (``None``: the
    card).  Raises unless ``data * model`` is the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the group has {world}")
    return init_device_mesh(resolve_device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))

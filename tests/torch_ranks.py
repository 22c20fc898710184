"""Run a function on several ranks of a ``torch.distributed`` group, for
the port's mesh tests: ``run_ranks(fn, root, world, *args)`` spawns
``world`` processes; each joins a ``gloo`` group through a ``file://``
store under ``root`` (no TCP port, so parallel test workers cannot
collide), runs ``fn(rank, device, *args)`` with one thread and returns
every rank's result, in rank order.  ``fn`` must be importable by name (the
``spawn`` start method pickles it so); the functions the mesh tests run
are here.  Nothing here imports JAX: the ``gpu`` tests use it on the
card."""
import dataclasses
import os
import pickle
import shutil

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import model_from_arrays
from repro_torch.launch.mesh import Mesh, init_ranks, make_host_mesh
from repro_torch.models import sharding as SH
from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.train.trainer import TrainConfig, Trainer

#: a collective that waits longer than this fails the rank (and the test)
TIMEOUT_S = 180
#: the SMOKE training runs: global batch, sequence, peak learning rate
B, S, LR = 4, 16, 1e-3


def _entry(rank, fn, world, root, device, args):
    torch.set_num_threads(1)
    dev = init_ranks("gloo", device=device,
                     init_method=f"file://{root}/store", rank=rank,
                     world_size=world, timeout_s=TIMEOUT_S)
    out = fn(rank, dev, *args)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, root, world, *args, device="cpu"):
    """``[fn(0, dev, *args), ..., fn(world - 1, dev, *args)]``, each in its
    own process on its device ``dev`` (``init_ranks``); a failure in any
    rank raises here (the others are stopped)."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    mp.start_processes(_entry, args=(fn, world, root, device, args),
                       nprocs=world, start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def host(t):
    """A tensor as a float64 numpy array (bfloat16 included)."""
    return t.detach().cpu().double().numpy()


# ---------------------------------------------------------- compressed_psum
def psum_ranks(rank, dev, inputs):
    """``compressed_psum`` of this rank's row of each input, int8 and
    bf16; and the inputs unchanged afterwards."""
    from repro_torch.train.optimizer import compressed_psum
    out = {}
    for name, (arr, dtype) in inputs.items():
        x = torch.from_numpy(arr[rank]).to(dev).to(getattr(torch, dtype))
        before = x.clone()
        out[name] = {bits: host(compressed_psum(x, bits=bits))
                     for bits in (8, 16)}
        out[name]["unchanged"] = bool(torch.equal(x, before))
    half = dist.new_group([0, 1])
    if rank < 2:
        x = torch.full((3,), float(rank + 1), device=dev)
        out["pair"] = host(compressed_psum(x, half))
    return out


# --------------------------------------------------------------- the mesh
def mesh_ranks(rank, dev, leaves):
    """On each mesh shape: this rank's coordinate, its shard of every leaf
    (``shard``) and the leaf gathered back (``gather``), with the spec
    of each leaf given per shape."""
    out = {}
    for shape, specs in leaves["specs"].items():
        mesh = make_host_mesh(*shape, device=dev)
        view = Mesh.of(mesh)
        got = {"coord": tuple(mesh.get_coordinate()),
               "view": (dict(view.shape), view.axis_names)}
        same = []
        for path, spec in specs.items():
            full = torch.from_numpy(leaves["arrays"][path]).to(dev)
            part = SH.shard(full, spec, mesh)
            back = SH.gather(part, spec, full.shape, mesh)
            same.append(bool(torch.equal(back, full)))
            got[path] = host(part)
        got["round_trip"] = all(same)
        out[shape] = got
    return out


# ------------------------------------------------------------- training
def smoke_config(arch, cf=8.0):
    """The SMOKE config with an MoE model's capacity factor ``cf`` (8: no
    token is dropped; ``None``: the config's own, which drops some)."""
    cfg = get_smoke_config(arch)
    if cfg.moe is None or cf is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def make_trainer(arch, layout, mesh, opt, accum, arrays, dev, ckpt_dir,
                 ckpt_every=100, cf=8.0):
    """A trainer of ``arch``'s SMOKE config (capacity factor ``cf``)
    starting from ``arrays`` (the JAX package's parameter tree), under
    ``layout``."""
    SH.set_layout(layout)
    cfg = smoke_config(arch, cf)
    tc = TrainConfig(lr=LR, warmup=2, total_steps=10, optimizer=opt,
                     grad_accum=accum, ckpt_dir=str(ckpt_dir),
                     ckpt_every=ckpt_every, log_every=100)
    return Trainer(cfg, tc, mesh, seq_len=S, global_batch=B, device=dev,
                   init_model=lambda: model_from_arrays(cfg, arrays, dev))


def checksum(tr) -> float:
    """The float64 sum of the full parameters as this rank holds them."""
    return float(sum(p.double().sum() for p in tr.params))


def held_bytes(tr):
    """``(held, expected, params)``: the bytes of this rank's slot shards,
    ``shard_bytes`` of the full slots under their specs, and the bytes
    of the full parameters that every rank holds."""
    held = sum(t.numel() * t.element_size()
               for t in tr.opt_leaves().values())
    want = SH.shard_bytes(tr.opt_leaves(full=True), tr.ospecs, tr.view)
    return held, want, sum(p.numel() * p.element_size() for p in tr.params)


def run_steps(tr, steps=4):
    """``steps`` train steps from step 0: the losses and, after each
    step, this rank's checksum."""
    tr.init_state()
    data = SyntheticLM(tr.cfg.vocab_size, S, B, seed=0)
    losses, sums = [], []
    for s in range(steps):
        m = tr.train_step(tr.local_batch(data.batch(s)), s)
        losses.append(float(m["loss"]))
        sums.append(checksum(tr))
    return losses, sums


def train_ranks(rank, dev, arrays_by_arch, cases, root):
    """Each case ``(arch, layout, shape, opt, accum, cf)``: 4 steps of the
    mesh trainer (``shape`` a mesh, or ``None`` for the one-device
    trainer on every rank; ``cf`` the capacity factor): losses,
    checksums, bytes held, and rank 0's full parameters after."""
    meshes, out = {}, {}
    for case in cases:
        arch, layout, shape, opt, accum, cf = case
        if shape is not None and shape not in meshes:
            meshes[shape] = make_host_mesh(*shape, device=dev)
        mesh = meshes.get(shape)
        tr = make_trainer(arch, layout, mesh, opt, accum,
                          arrays_by_arch[arch], dev, f"{root}/unused", cf=cf)
        losses, sums = run_steps(tr)
        out[case] = dict(losses=losses, sums=sums,
                         bytes=held_bytes(tr) if mesh is not None else None,
                         params=dict(zip(tr.keys, map(host, tr.params)))
                         if rank == 0 else None)
    SH.set_layout("tp")
    return out


def elastic_ranks(rank, dev, arrays, root, jax_ckpt):
    """The checkpoint paths of the mesh trainer (qwen2.5-3b SMOKE, AdamW):

    * ``same``: 4 steps on (2, 2) saving at steps 2 and 4, then a fresh
      trainer on (2, 2) resuming step 2 (losses of steps 3-4, both runs);
    * ``port_cont``: the step-4 checkpoint resumed on (4, 1), 2 steps
      (the port's continuation of its own checkpoint; the JAX package
      resumes the same checkpoint in its test);
    * ``one_cont``: the same checkpoint resumed on one device, 2 steps;
    * ``from_jax``: the JAX package's (2, 2) step-4 checkpoint
      ``jax_ckpt`` resumed on (4, 1), 2 steps;
    * ``state_equal``: the resumed state equal to the checkpoint, bit
      for bit, on (4, 1)."""
    arch, opt = "qwen2_5_3b", "adamw"
    m22 = make_host_mesh(2, 2, device=dev)
    m41 = make_host_mesh(4, 1, device=dev)
    silent = dict(log=lambda *a: None)
    a = make_trainer(arch, "tp", m22, opt, 1, arrays, dev, f"{root}/a", 2)
    run_a = a.fit(4, **silent)["losses"]
    if rank == 0:
        shutil.copytree(f"{root}/a/step_2", f"{root}/b/step_2")
        for d in ("c", "d"):
            shutil.copytree(f"{root}/a/step_4", f"{root}/{d}/step_4")
        shutil.copytree(jax_ckpt, f"{root}/e")
    dist.barrier()
    b = make_trainer(arch, "tp", m22, opt, 1, arrays, dev, f"{root}/b", 2)
    run_b = b.fit(4, **silent)["losses"]
    c = make_trainer(arch, "tp", m41, opt, 1, arrays, dev, f"{root}/c", 100)
    port_cont = c.fit(6, **silent)["losses"]
    e = make_trainer(arch, "tp", m41, opt, 1, arrays, dev, f"{root}/e", 100)
    from_jax = e.fit(6, **silent)["losses"]
    check = make_trainer(arch, "fsdp", m41, opt, 1, arrays, dev,
                         f"{root}/d", 100)
    step = check.restore()
    params, opt_tree = check.state_tree()
    saved, _ = restore_checkpoint(f"{root}/d", step, (params, opt_tree))
    live = SH.flatten({"p": params, "o": opt_tree})
    saved = SH.flatten({"p": saved[0], "o": saved[1]})
    state_equal = step == 4 and live.keys() == saved.keys() and all(
        torch.equal(live[k].cpu(), saved[k]) for k in live)
    one = None
    if rank == 0:
        one = make_trainer(arch, "tp", None, opt, 1, arrays, dev,
                           f"{root}/d", 100).fit(6, **silent)["losses"]
    SH.set_layout("tp")
    return dict(run_a=run_a, run_b=run_b, port_cont=port_cont,
                from_jax=from_jax, state_equal=state_equal, one_cont=one)


def launch_ranks(rank, dev, port, ckpt_dir):
    """``launch.train.main`` under ``torchrun``'s environment (rank,
    world size, a localhost rendezvous): ``--model 2`` on 4 ranks."""
    from repro_torch.launch import train as launch
    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="4",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    out = launch.main(["--arch", "qwen2_5_3b", "--smoke", "--steps", "3",
                       "--seq", "16", "--batch", "4", "--device", "cpu",
                       "--model", "2", "--ckpt-dir", str(ckpt_dir)])
    return out["losses"]

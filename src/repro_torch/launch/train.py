"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \
        --smoke --steps 100 --seq 128 --batch 8 --device cpu

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen2_5_3b --smoke --model 2

The port of ``repro/launch/train.py``, with ``--device`` (default the
card) in place of the production mesh.  ``--arch`` takes any of
``configs.list_archs()``; ``--smoke`` trains the registered SMOKE config,
without it the published one.  The loop writes a checkpoint every
``--ckpt-every`` steps and at the end, and resumes from the latest one in
``--ckpt-dir`` (loss descends, checkpoints, resumes).

Under ``torchrun`` (``WORLD_SIZE`` > 1; ``--standalone`` rendezvouses on
this host, no network) every process is one rank of a ``("data",
"model")`` mesh of ``WORLD_SIZE // --model`` by ``--model`` ranks
(``launch.mesh.init_ranks``, ``make_host_mesh``), trained as the JAX
package's trainer on its host mesh.  ``--backend`` defaults to ``nccl``
on the card (one card a rank) and ``gloo`` on the CPU; ranks that share
a card take ``--backend gloo``.  Without ``torchrun`` it runs on one
device, as before.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import init_ranks, make_host_mesh
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", type=int, default=1,
                    help="the mesh's model axis under torchrun")
    ap.add_argument("--backend", default=None,
                    help="under torchrun: nccl (default on the card) or "
                         "gloo (default on the CPU)")
    args = ap.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh, device = None, args.device
    if world > 1:
        backend = args.backend or ("gloo" if args.device == "cpu"
                                   else "nccl")
        device = init_ranks(backend, device=args.device)
        mesh = make_host_mesh(world // args.model, args.model, device=device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(lr=args.lr, warmup=max(args.steps // 10, 1),
                     total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, optimizer=args.optimizer)
    tr = Trainer(cfg, tc, mesh, seq_len=args.seq, global_batch=args.batch,
                 device=device)
    out = tr.fit(args.steps)
    if tr.rank == 0:
        print(f"final loss: {out['losses'][-1]:.4f} "
              f"(from {out['losses'][0]:.4f})")
    if mesh is not None:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()

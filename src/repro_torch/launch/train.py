"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \
        --smoke --steps 100 --seq 128 --batch 8 --device cpu

The port of ``repro/launch/train.py``, with ``--device`` (default the
card) in place of the mesh.  ``--arch`` takes any of
``configs.list_archs()``; ``--smoke`` trains the registered SMOKE config,
without it the published one.  The loop writes a checkpoint every
``--ckpt-every`` steps and at the end, and resumes from the latest one in
``--ckpt-dir`` (loss descends, checkpoints, resumes).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, get_smoke_config
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
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(lr=args.lr, warmup=max(args.steps // 10, 1),
                     total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, optimizer=args.optimizer)
    tr = Trainer(cfg, tc, seq_len=args.seq, global_batch=args.batch,
                 device=args.device)
    out = tr.fit(args.steps)
    print(f"final loss: {out['losses'][-1]:.4f} "
          f"(from {out['losses'][0]:.4f})")
    return out


if __name__ == "__main__":
    main()

"""Training launcher.

The port of ``repro.launch.train``: the same command line, plus
``--device`` (``cuda`` unless the CPU is asked for), ``--log-every`` and
``--ckpt-every 0`` (no checkpoints). It needs no mesh: the model trains
on one device. Examples:

  # a smoke config for a few steps on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --smoke --steps 20 --seq-len 32 --batch 4 --device cpu

  # gemma2-2b at full width and depth on the card:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 4 --seq-len 4608 --batch 1 --ckpt-every 0

``main(argv, on_step=None)`` returns the trainer's result (model,
optimizer state, history); ``on_step`` goes to ``Trainer``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_loop import Trainer, TrainerConfig


def main(argv: list[str] | None = None, on_step=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=cfgbase.list_architectures())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (0: none)")
    ap.add_argument("--hedged-loader-k", type=int, default=2,
                    help="redundant data-loader copies (the paper's "
                         "technique on the input pipeline)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (cfgbase.get_smoke_config(args.arch) if args.smoke
           else cfgbase.get_config(args.arch))
    print(f"[train] arch={cfg.name} params~{cfg.param_count/1e6:.1f}M "
          f"device={dev} cuda devices={torch.cuda.device_count()}")
    dcfg = DataConfig(seq_len=args.seq_len, batch_size=args.batch,
                      seed=args.seed)
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         hedged_loader_k=args.hedged_loader_k,
                         log_every=args.log_every)
    trainer = Trainer(cfg, dcfg, tcfg,
                      opt=make_optimizer(cfg.optimizer, lr=args.lr),
                      device=dev, on_step=on_step)
    out = trainer.run(args.steps, seed=args.seed)
    print(f"[train] done; final loss "
          f"{out['history'][-1]['loss']:.4f}; "
          f"loader duplicate wins: {out['loader_duplicate_wins']}")
    return out


if __name__ == "__main__":
    main()

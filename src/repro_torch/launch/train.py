"""Training launcher.

The port of ``repro.launch.train``: the same command line, plus
``--device`` (``cuda`` unless the CPU is asked for), ``--log-every``,
``--ckpt-every 0`` (no checkpoints) and a test mesh: ``--mesh DATA
MODEL`` spawns DATA x MODEL ranks on this machine (``--multi-pod``: two
pods of them) joined over gloo, which train the model sharded under the
arch's train layout (``sharding.make_layout(cfg, "train", multi_pod)``;
the fsdp recipe's with two pods splits the sequence over ``pod``). On
one card every rank takes it. Without ``--mesh`` the model trains on
one device. Examples:

  # a smoke config for a few steps on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --smoke --steps 20 --seq-len 32 --batch 4 --device cpu

  # the smoke gemma2-2b on 8 CPU ranks, the sequence split over 2 pods:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --smoke --steps 4 --seq-len 32 --batch 4 --device cpu \\
      --mesh 2 2 --multi-pod --ckpt-every 0

  # gemma2-2b at full width and depth on the card:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 4 --seq-len 4608 --batch 1 --ckpt-every 0

``main(argv, on_step=None)`` returns the trainer's result (model,
optimizer state, history); ``on_step`` goes to ``Trainer``. With
``--mesh`` it returns rank 0's history and the rank count (``on_step``
is not taken: the ranks run in other processes).
"""
from __future__ import annotations

import argparse
import json
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
    ap.add_argument("--mesh", type=int, nargs=2, metavar=("DATA", "MODEL"),
                    help="train sharded on DATA x MODEL spawned ranks")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --mesh: two pods of them (the train layout's "
                         "multi-pod form)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.mesh:
        return _sharded(args)
    if args.multi_pod:
        raise ValueError("--multi-pod takes a --mesh")
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


def _sharded(args) -> dict:
    """Spawn the mesh's ranks, each a ``Trainer`` under the train layout;
    rank 0's history comes back through a file."""
    from repro_torch.distributed import multihost

    n = args.mesh[0] * args.mesh[1] * (2 if args.multi_pod else 1)
    with tempfile.TemporaryDirectory() as tmp:
        multihost.spawn(_rank, n, (vars(args), tmp), limit_s=24 * 3600.0)
        with open(os.path.join(tmp, "history.json")) as f:
            history = json.load(f)
    print(f"[train] done on {n} ranks; final loss {history[-1]['loss']:.4f}")
    return {"history": history, "ranks": n}


def _rank(rank: int, args: dict, tmp: str) -> None:
    from repro_torch.distributed import multihost, sharding
    from repro_torch.launch.mesh import make_test_mesh

    n_data, n_model = args["mesh"]
    n = n_data * n_model * (2 if args["multi_pod"] else 1)
    multihost.initialize(f"file://{tmp}/store", n, rank,
                         device=args["device"], set_default_mesh=False)
    try:
        cfg = (cfgbase.get_smoke_config(args["arch"]) if args["smoke"]
               else cfgbase.get_config(args["arch"]))
        mesh = make_test_mesh(n_data, n_model,
                              n_pod=2 if args["multi_pod"] else None)
        layout = sharding.make_layout(cfg, "train", args["multi_pod"],
                                      args["batch"])
        ctx = sharding.make_ctx(cfg, mesh, layout)
        if rank == 0:
            print(f"[train] arch={cfg.name} on {n} ranks: batch over "
                  f"{layout.batch}, sequence over {layout.seq}, experts "
                  f"over {layout.ep_axes}")
        dcfg = DataConfig(seq_len=args["seq_len"],
                          batch_size=args["batch"], seed=args["seed"])
        tcfg = TrainerConfig(ckpt_dir=args["ckpt_dir"],
                             ckpt_every=args["ckpt_every"],
                             hedged_loader_k=args["hedged_loader_k"],
                             log_every=args["log_every"])
        dev = multihost._rank_device(args["device"], rank)
        if dev.type == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        out = Trainer(cfg, dcfg, tcfg,
                      opt=make_optimizer(cfg.optimizer, lr=args["lr"]),
                      device=dev, ctx=ctx,
                      log_fn=print if rank == 0 else (lambda s: None)
                      ).run(args["steps"], seed=args["seed"])
        if rank == 0:
            with open(os.path.join(tmp, "history.json"), "w") as f:
                json.dump(out["history"], f)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()

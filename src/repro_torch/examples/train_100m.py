"""End-to-end example: train a ~100M-parameter model for a few hundred
steps with the full substrate — deterministic data pipeline, hedged
(redundant) data loading, async checkpointing, crash-safe resume.

The port of ``examples/train_100m.py``: the same 105M config and flags,
plus ``--device`` (``cuda`` unless the CPU is asked for),
``--ckpt-every`` (50, as the JAX example), ``--fail-at-step`` (the
trainer's injected failure, to rehearse a resume) and ``--log-every``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 200]

``main(argv, on_step=None)`` returns the trainer's result.
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_loop import Trainer, TrainerConfig


def model_100m() -> ModelConfig:
    # ~105M params: 12L, d768, GQA 12/4 heads — a GPT-2-small-ish config
    # assembled from the same blocks as the assigned architectures.
    return ModelConfig(
        name="repro-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=32_000,
        pattern=("global",), mlp_act="silu", gated_mlp=True,
        tie_embeddings=True, recipe="tp", long_context_ok=False)


def main(argv=None, on_step=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_100m"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_100m()
    print(f"params ~ {cfg.param_count / 1e6:.1f}M")
    trainer = Trainer(
        cfg,
        DataConfig(seq_len=args.seq_len, batch_size=args.batch, seed=0),
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      hedged_loader_k=2, log_every=args.log_every,
                      fail_at_step=args.fail_at_step),
        opt=make_optimizer("adamw", lr=3e-4), device=args.device,
        on_step=on_step)
    out = trainer.run(args.steps)
    print(f"final loss {out['history'][-1]['loss']:.4f}; "
          f"hedged-loader duplicate wins: {out['loader_duplicate_wins']}")
    return out


if __name__ == "__main__":
    main()

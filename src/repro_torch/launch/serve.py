"""Serving launcher: replica group + hedged scheduler (the paper's system).

The port of ``repro.launch.serve``: the same command line, plus
``--device`` (``cuda`` unless the CPU is asked for). ``--arch`` is any
architecture the port registers (gemma2-2b, mamba2-370m,
recurrentgemma-9b); on the card the replicas run its kernels
(attention, ``ssd_scan``, ``rglru_scan``). Example (CPU, smoke model, 4
replicas, redundancy on):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --smoke --replicas 4 --requests 64 --max-k 2 --device cpu

``main(argv)`` returns the latencies (seconds) and the scheduler's stats.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.core.hedging import HedgePolicy
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import HedgedScheduler


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=cfgbase.list_architectures())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-k", type=int, default=2)
    ap.add_argument("--threshold", type=float, default=0.25,
                    help="utilization threshold for hedging (paper: the "
                         "threshold load is in (0.26, 0.5))")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (cfgbase.get_smoke_config(args.arch) if args.smoke
           else cfgbase.get_config(args.arch))
    model = lm.init(torch.Generator(dev).manual_seed(args.seed), cfg)
    engines = [InferenceEngine(cfg, model, max_len=128, name=f"replica{i}",
                               device=dev)
               for i in range(args.replicas)]
    sched = HedgedScheduler(
        engines, policy=HedgePolicy(max_k=args.max_k,
                                    threshold=args.threshold),
        seed=args.seed)
    rng = np.random.default_rng(args.seed)
    lat = []
    try:
        for _ in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
            req = sched.submit(prompt, max_new_tokens=args.max_new_tokens)
            lat.append(req.latency)
    finally:
        sched.shutdown()
    lat = np.asarray(lat)
    print(f"[serve] n={len(lat)} mean={lat.mean()*1e3:.1f}ms "
          f"p50={np.percentile(lat, 50)*1e3:.1f}ms "
          f"p99={np.percentile(lat, 99)*1e3:.1f}ms")
    print(f"[serve] stats={sched.stats}")
    return {"latency_s": lat, "stats": dict(sched.stats)}


if __name__ == "__main__":
    main()

"""Serving launcher: replica group + hedged scheduler (the paper's system).

The port of ``repro.launch.serve``: the same command line, plus
``--device`` (``cuda`` unless the CPU is asked for). ``--arch`` is any
registered architecture; on the card the replicas run its kernels
(attention, ``ssd_scan``, ``rglru_scan``). The engine feeds token
prompts, as the JAX engine does, so musicgen-large (audio) and
llava-next-34b (patches) raise there and are served through
``repro_torch.models.decode``. Example (CPU, smoke model, 4 replicas,
redundancy on):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --smoke --replicas 4 --requests 64 --max-k 2 --device cpu

``--trace-out PATH`` writes, when the run ends, one JSON line a request:
its trace (``serving.metrics.RequestTrace``: the submit stamp, the k and
the utilization the scheduler decided on, whether it shed) with its
copies' spans (queue wait, the copy's run and outcome, each prefill and
decode step split into the host's enqueue and the wait for the token).

``main(argv)`` returns the latencies (seconds) and the scheduler's stats.
"""
from __future__ import annotations

import argparse
import json

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
    ap.add_argument("--trace-out", default=None,
                    help="write each request's trace and its copies' spans "
                         "here, one JSON line a request, when the run ends")
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
    reqs = []
    try:
        for _ in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
            reqs.append(sched.submit(prompt,
                                     max_new_tokens=args.max_new_tokens))
    finally:
        sched.shutdown()
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            for req in reqs:
                f.write(json.dumps(req.trace.to_json()) + "\n")
    lat = np.asarray([req.latency for req in reqs])
    print(f"[serve] n={len(lat)} mean={lat.mean()*1e3:.1f}ms "
          f"p50={np.percentile(lat, 50)*1e3:.1f}ms "
          f"p99={np.percentile(lat, 99)*1e3:.1f}ms")
    print(f"[serve] stats={sched.stats}")
    return {"latency_s": lat, "stats": dict(sched.stats)}


if __name__ == "__main__":
    main()

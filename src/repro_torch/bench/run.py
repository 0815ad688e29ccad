"""Benchmark harness of the PyTorch port — one module per paper
table/figure (the twins of the JAX package's ``benchmarks/``).

    python -m repro_torch.bench.run                     # every module, card
    python -m repro_torch.bench.run --only fig15        # one module
    python -m repro_torch.bench.run --only serving_hedge
    python -m repro_torch.bench.run --smoke --device cpu --json BENCH_cpu.json

Prints ``name,us_per_call,derived`` CSV and, on standard error, each
module's wall seconds. ``--only`` is a substring filter on module names
(repeatable). ``--smoke`` runs every module at tiny sizes. ``--json
PATH`` also writes the rows as a JSON list; each row records its
``mesh`` (always null: the sharded executor is not ported), the
``scenario`` it measured (``repro_torch.core.scenario.provenance``;
null for rows that are not a queueing-scenario measurement), the
RESOLVED cell-update ``kernel`` mode (``on`` / ``off``; null for rows
with no engine call), ``backend: "torch"``, the ``device`` and the
card's name and power limit (``gpu``, as ``nvidia-smi
--query-gpu=name,power.limit`` gives them; ``"cpu"`` on the CPU).
``--kernel`` picks the engine's mode (``auto``: the CUDA kernel on the
card). ``--device`` defaults to ``cuda`` and raises where there is none.
A module that fails raises: the harness has no fallback.

``main(argv)`` returns ``{"rows": [...], "walls": {module: seconds}}``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time

from repro_torch.bench import (fig1_queueing, fig2_threshold, fig3_random,
                               fig4_overhead, fig5_diskdb, fig12_memcached,
                               fig14_network, fig15_dns, fig_cross_system,
                               fig_fault_masking, fig_policy_space, roofline,
                               serving_hedge, sweep_engine, tab_tcp)
from repro_torch.bench.common import row_provenance
from repro_torch.device import resolve_device

# the JAX harness's order (``benchmarks/run.py``)
MODULES = (sweep_engine, fig_policy_space, fig1_queueing, fig2_threshold,
           fig3_random, fig4_overhead, fig5_diskdb, fig12_memcached,
           fig14_network, fig15_dns, fig_cross_system, tab_tcp,
           fig_fault_masking, serving_hedge, roofline)


def card_line(dev) -> str:
    """The card's name and power limit, or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", action="append", default=None,
                    help="substring filter on module names (repeatable)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write rows to PATH as a JSON list")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes: exercise every module quickly")
    ap.add_argument("--kernel", choices=("auto", "on", "off"),
                    default="auto",
                    help="cell-update kernel mode of the engine figures "
                         "(auto: the kernel on the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    provenance = {"backend": "torch", "device": dev.type,
                  "gpu": card_line(dev)}

    print("name,us_per_call,derived")
    collected: list[dict] = []
    walls: dict[str, float] = {}
    for mod in MODULES:
        name = mod.__name__.split(".")[-1]
        if args.only and not any(o in name for o in args.only):
            continue
        kwargs = {"smoke": args.smoke, "device": args.device}
        if "kernel" in inspect.signature(mod.run).parameters:
            kwargs["kernel"] = args.kernel
        t0 = time.perf_counter()
        rows = mod.run(**kwargs)
        walls[name] = time.perf_counter() - t0
        for row in rows:
            row_name, us, derived = row[:3]
            row_mesh, row_scenario, row_kernel = row_provenance(row)
            print(f"{row_name},{us:.1f},{derived}", flush=True)
            collected.append({"name": row_name, "us_per_call": round(us, 1),
                              "derived": derived, "mesh": row_mesh,
                              "scenario": row_scenario, "kernel": row_kernel,
                              **provenance})
        print(f"# {name} {walls[name]:.2f}s", file=sys.stderr, flush=True)
    print(f"# total {sum(walls.values()):.1f}s", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(collected, f, indent=1)
        print(f"# wrote {len(collected)} rows to {args.json}",
              file=sys.stderr)
    return {"rows": collected, "walls": walls}


if __name__ == "__main__":
    main()

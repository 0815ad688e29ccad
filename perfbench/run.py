#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the last line of standard output is the result with
the cell's end-to-end metrics; with ``--trace 1`` with its per-layer
metrics, read from a ``torch.profiler`` trace of the window. The numbers
that decide ``correct`` are the last lines of standard error and the
last key of the result. Exits 2, with no result, without a CUDA card
(or fewer than the cell asks for) and 3 if the process holds JAX or the
JAX package (``repro``) after the window.
"""
import os
import time


def _process_start() -> float:
    """``time.perf_counter()`` at the start of this process (Linux:
    from its start time in /proc; elsewhere: now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache the program or the toolkit writes stays inside the checkout
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / ".cache" / "cuda"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".cache" / "triton"))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list[str]:
    """Modules whose top-level name (before the first dot) is, as a
    whole word, JAX's or the JAX package's (``repro_torch`` is not)."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness, spec
    cell = spec.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{torch.cuda.device_count()} cards, the cell asks for "
              f"{cell.chips}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"the process holds JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    harness.log(harness.card_line())
    for name, v in result["check"].items():
        harness.log(f"check {name}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

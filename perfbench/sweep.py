#!/usr/bin/env python3
"""Find the highest rate an open-loop cell sustains, once, on the card:

    python3 perfbench/sweep.py --workload <name> --seed <n> --seconds <s> --rates 3 4 5

One process, one set of weights; for each rate the cell's schedule at
that rate for ``--seconds``, then a wait until every request is done.
Each rate prints one JSON line: requests due, mean and p90 latency from
the due time, the mean latency of the last third of the window against
the first third (a backlog that grows shows as a rising ratio), and how
long after the close the last request finished. The cell's own file
records the sustained rate that the sweep found; the benchmark's runs
never search for it."""
import sys
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from perfbench import harness, loadgen, spec
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload, ROOT)
    dev = torch.device("cuda", 0)
    s = harness.prepare(cell, args.seed, dev, False, rate=args.rates[0])
    harness.log(f"setup {time.perf_counter() - T0:.1f} s")
    for rate in args.rates:
        s.items = loadgen.schedule(cell.traffic, rate)
        s.schedule_s = 0.0   # each rate's window starts its own schedule
        w = harness.run_window(s, args.seconds)
        lat = np.array([r["done"] - r["due"] if r["done"] else np.inf
                        for r in w.records])
        third = max(len(lat) // 3, 1)
        done = [r["done"] for r in w.records if r["done"]]
        print(json.dumps({
            "rate_per_s": rate, "due": len(lat),
            "unfinished": int(np.sum(~np.isfinite(lat))),
            "mean_ms": float(np.mean(lat) * 1e3),
            "p90_ms": float(np.sort(lat)[int(np.ceil(0.9 * len(lat))) - 1]
                            * 1e3),
            "last_over_first_third": float(np.mean(lat[-third:])
                                           / np.mean(lat[:third])),
            "drain_s": (max(done) - w.close) if done else None,
            "copies_per_request": (w.stats["total"] + w.stats["hedged"])
            / max(w.stats["total"], 1)}), flush=True)
        harness._wait_idle(s.service)
    harness.teardown(s)
    harness.log(harness.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

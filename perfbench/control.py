#!/usr/bin/env python3
"""The control of a cell's ``correct``, on the card at the cell's own
size (the benchmark's runs never run it):

    python3 perfbench/control.py --workload <name> --seconds <s> --seeds 1 2 3

For each seed, in one process: weights from the seed, the cell's
traffic for ``--seconds`` at its own load, the program's state freed,
and then over the same sample of finished requests as a run reads, the
program's numbers against the float32 reference (``served_gap``,
``logit_error``: the lower readings of the limits) and the same numbers
of the reference computed in fp8 in the program's place
(``control_gap``, ``control_logit_error``: the upper readings). One JSON
line a seed. With ``--fault``, the program runs with that fault planted
(``perfbench/tests/faults.py``), to read what the fault moves."""
import gc
import sys
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(s, w, seed: int) -> dict:
    from perfbench import check
    rows = check.sample(w.records, int(s.cell.config["check"]
                                       ["sample_requests"]), seed)
    t = time.perf_counter()
    got = check.readings(s, rows, s.recorder.copies, control=True)
    return {"seed": seed, "requests": len(rows),
            "served_tokens": sum(len(r["req"].out_tokens) for r in rows),
            **got, "reference_s": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="none",
                    help="a fault of perfbench/tests/faults.py planted under "
                         "the timed path once set-up is done")
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness, spec
    from perfbench.tests import faults
    faults.plant(args.fault)
    cell = spec.find_cell(args.workload, ROOT)
    dev = (torch.device("cuda", 0) if torch.cuda.is_available()
           else torch.device("cpu"))
    for seed in args.seeds:
        s = harness.prepare(cell, seed, dev, False)
        w = harness.run_window(s, args.seconds)
        harness.teardown(s)
        print(json.dumps(readings(s, w, seed)), flush=True)
        del s, w
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

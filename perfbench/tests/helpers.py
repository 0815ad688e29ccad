"""Helpers of the benchmark's CPU tests: a temporary checkout holding
the benchmark's files and a smoke cell added only as new files."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_DENSE = {
    "name": "nemotron-4-15b-smoke", "family": "dense", "n_layers": 2,
    "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
    "d_ff": 256, "vocab_size": 512, "pattern": ["global"],
    "mlp_act": "relu2", "gated_mlp": False, "recipe": "tp",
    "long_context_ok": False}
TINY_MOE = {
    "name": "granite-moe-3b-a800m-smoke", "family": "moe", "n_layers": 2,
    "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
    "d_ff": 64, "vocab_size": 512, "pattern": ["global_moe"],
    "moe": {"n_experts": 10, "top_k": 2, "d_expert": 64},
    "mlp_act": "silu", "gated_mlp": True, "tie_embeddings": True,
    "recipe": "fsdp", "long_context_ok": False}


def checkout(tmp: Path) -> Path:
    """A checkout holding only what git commits of the benchmark, with
    the program beside it (a link to ``src``)."""
    root = tmp / "checkout"
    root.mkdir()
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    (root / "src").symlink_to(REPO / "src")
    return root


def add_cell(root: Path, name: str, port: dict, reference: str, mix: dict,
             own: dict, sample: int = 8, precision: str = "float32") -> str:
    """Add a cell as new files only, and its entries to BENCHMARK.json;
    ``precision`` is the reference's (``check.reference_precision``)."""
    pb = root / "perfbench"
    conf = {"name": name, "reduced": [], "reference": reference,
            "assumed": {"replicas": 2, "max_len": 64,
                        "hedge": {"max_k": 2, "threshold": 0.25}},
            "check": {"sample_requests": sample,
                      "reference_precision": precision}, "port": port}
    (pb / "configs" / f"{name}.json").write_text(json.dumps(conf))
    traffic = f"{name}-mix"
    (pb / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    cell = f"{name}.{traffic}"
    (pb / "cells" / f"{cell}.json").write_text(json.dumps(own))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": name, "source": "smoke",
                            "file": f"perfbench/configs/{name}.json",
                            "reduced": [], "why": "smoke"})
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": traffic, "chips": 1, "why": "smoke"})
    e2e = (("latency_mean_ms", "latency_p85_ms") if mix["loop"] == "open"
           else ("tokens_per_s",))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in e2e or m.get("moves") in e2e:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return cell


RUNNER = """
import json, sys, time
t0 = time.perf_counter()
sys.path[:0] = ['.', 'src']
import torch
from perfbench import harness
from perfbench.tests import faults
faults.plant(sys.argv[4])
r = harness.run_cell(sys.argv[1], int(sys.argv[2]), float(sys.argv[3]),
                     sys.argv[5] == '1', torch.device('cpu'), t0)
forbidden = sorted(m for m in sys.modules
                        if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'repro'))
print(json.dumps({'run': r, 'forbidden': forbidden}))
"""


def run_cpu(root: Path, cell: str, seed: int, seconds: float,
            fault: str = "none", trace: bool = False) -> dict:
    """Drive a run on the CPU (the look for a card skipped) in a fresh
    process from ``root``; ``fault`` plants one of ``faults.FAULTS``.
    The process must hold no JAX and no JAX package after the run."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.run([sys.executable, "-c", RUNNER, cell, str(seed),
                        str(seconds), fault, str(int(trace))], cwd=root,
                       env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == [], out["forbidden"]
    return out["run"]

"""Roofline of the ``cell_update`` kernel on the H100's peaks.

Part 1 — the ``cell_update`` kernel, MEASURED: the analytic cost model
``cell_update_costs`` (FLOPs, device-memory traffic, arithmetic
intensity of one engine call) against the timed wall clock of
``queueing.run`` with ``kernel="off"`` (the plain version) and with the
kernel (the resolved ``"on"``). Reports achieved GFLOP/s and GB/s, their
fractions of the card's published peaks (``repro_torch.device``: the
float32 rate outside the tensor cores and the memory rate), the ridge
intensity the kernel must beat to leave the memory-bound regime, and
the measured kernel-vs-plain speedup. On the CPU there is no kernel:
both legs run the plain version, and their fractions are of the card's
peaks all the same. ``smoke=True`` shrinks the measured sweep.

Part 2 — the dry-run records (``repro_torch.launch.dryrun``), when
present in ``DRYRUN_DIR``, one row per (arch x shape x mesh) on the
card's peaks (``repro_torch.device``):
    compute term    = scaled_flops / bf16 tensor-core rate
    memory term     = scaled_io_bytes / device-memory rate
    collective term = collective bytes / NVLink rate (published)
(the records store PER-RANK values). Also MODEL_FLOPS = 6 N(_active) D
for a train step, 2 N D for a prefill, 2 N B for a decode step, a rank's
share of it, and the usefulness ratio. Without the directory the module
emits the ``roofline/dryrun_missing`` row, as the JAX module does; it
never reads the JAX package's records (TPU compiles).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from repro_torch.bench.common import Row, timed
from repro_torch.core import distributions as dists, queueing
from repro_torch.core.scenario import Scenario
from repro_torch.configs import base as cfgbase
from repro_torch.device import (BF16_OPS_PER_S, F32_OPS_PER_S,
                                HBM_BYTES_PER_S, NVLINK_BYTES_PER_S)
from repro_torch.kernels import dispatch
from repro_torch.kernels.cell_update.ops import cell_update_costs

RIDGE = F32_OPS_PER_S / HBM_BYTES_PER_S  # FLOP/byte: compute overtakes memory
DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


def analyze_record(rec: dict) -> dict | None:
    """The roofline terms of one dry-run record on the card's peaks
    (``benchmarks/roofline.py``'s ``analyze_record``); None for a failed
    cell or one without the counts."""
    if not rec.get("ok") or "scaled_flops" not in rec or \
            rec.get("shape") not in cfgbase.SHAPES:
        return None
    cfg = cfgbase.get_config(rec["arch"])
    shape = cfgbase.SHAPES[rec["shape"]]
    devices = rec["devices"]
    t_compute = rec["scaled_flops"] / BF16_OPS_PER_S
    t_memory = rec["scaled_io_bytes"] / HBM_BYTES_PER_S
    coll = sum(rec.get("collective_bytes", {}).values())
    t_coll = coll / NVLINK_BYTES_PER_S
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda x: x[1])[0]
    n_params = (cfg.active_param_count if cfg.moe else cfg.param_count)
    if shape.kind == "train":
        model_flops = 6 * n_params * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * n_params * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        model_flops = 2 * n_params * shape.global_batch
    model_flops_dev = model_flops / devices
    return {
        "t_compute": t_compute, "t_memory": t_memory, "t_coll": t_coll,
        "dominant": dominant,
        "useful_ratio": model_flops_dev / max(rec["scaled_flops"], 1.0),
        "model_flops_per_dev": model_flops_dev,
        "hbm_bytes_per_dev": rec.get("temp_size_in_bytes", 0),
    }


def dryrun_rows(directory: Path | None = None) -> list[Row]:
    """One row per record of ``directory`` (default ``DRYRUN_DIR``); the
    ``roofline/dryrun_missing`` row where it does not exist."""
    directory = DRYRUN_DIR if directory is None else Path(directory)
    if not directory.exists():
        return [("roofline/dryrun_missing", 0.0,
                 "run repro_torch.launch.dryrun first")]
    rows: list[Row] = []
    for f in sorted(directory.glob("*.json")):
        rec = json.loads(f.read_text())
        a = analyze_record(rec)
        if a is None:
            rows.append((f"roofline/{f.stem}", 0.0,
                         f"SKIP({rec.get('error', 'no analysis')})"))
            continue
        rows.append((
            f"roofline/{f.stem}", rec.get("trace_s", 0) * 1e6,
            f"compute_s={a['t_compute']:.3e};memory_s={a['t_memory']:.3e};"
            f"collective_s={a['t_coll']:.3e};dominant={a['dominant']};"
            f"useful={a['useful_ratio']:.2f}"))
    return rows


def _cell_update_rows(smoke: bool, device) -> list[Row]:
    """Measured roofline of the ``cell_update`` kernel vs its plain
    version: one row per path (plain / kernel) with its wall clock,
    analytic FLOPs and bytes, achieved rates and their peak fractions,
    plus a summary row with the speedup and the ridge intensity. The
    kernel leg is timed on its second call (the first builds it)."""
    n_arrivals = 5_000 if smoke else 20_000
    n_seeds, chunk = 2, 4_096
    cfg = queueing.SimConfig(n_servers=20, n_arrivals=n_arrivals)
    scn = Scenario.paper_default(dists.exponential(), ks=(1, 2))
    rhos = np.linspace(0.1, 0.4, 3, dtype=np.float32)
    costs = cell_update_costs(
        n_cells=n_seeds * rhos.shape[0] * 2, n_servers=cfg.n_servers,
        k_max=2, n_arrivals=n_arrivals, n_bins=queueing.DEFAULT_BINS,
        n_seeds=n_seeds, chunk=chunk)

    kmode = dispatch.resolve("auto", device)  # "on" on the card
    rows: list[Row] = []
    secs = {}
    for label, mode in (("scan", "off"), ("kernel", kmode)):
        def call(mode=mode):
            return queueing.run(3, scn, rhos, cfg, n_seeds=n_seeds,
                                chunk_size=chunk, kernel=mode, device=device)
        if mode == "on":
            timed(call)  # the build and first launch, outside the timing
        _, us = timed(call)
        s = secs[label] = us * 1e-6
        gflops = costs["flops"] / s / 1e9
        gbs = costs["hbm_bytes"] / s / 1e9
        rows.append((f"roofline/cell_update/{label}", us,
                     f"kernel={mode};flops={costs['flops']:.3e};"
                     f"hbm_bytes={costs['hbm_bytes']:.3e};"
                     f"achieved_gflops={gflops:.2f};"
                     f"peak_frac={gflops * 1e9 / F32_OPS_PER_S:.2e};"
                     f"achieved_gbs={gbs:.2f};"
                     f"hbm_frac={gbs * 1e9 / HBM_BYTES_PER_S:.2e}",
                     None, None, mode))
    rows.append(("roofline/cell_update/summary", secs["kernel"] * 1e6,
                 f"kernel={kmode};intensity={costs['intensity']:.1f};"
                 f"ridge={RIDGE:.1f};"
                 f"compute_bound={costs['intensity'] > RIDGE};"
                 f"scan_s={secs['scan']:.2f};kernel_s={secs['kernel']:.2f};"
                 f"speedup={secs['scan'] / secs['kernel']:.2f}x",
                 None, None, kmode))
    return rows


def run(smoke: bool = False, device="cuda") -> list[Row]:
    return _cell_update_rows(smoke, device) + dryrun_rows()

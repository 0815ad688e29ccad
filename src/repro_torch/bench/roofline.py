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

Part 2 — the dry-run cost analysis of the JAX package's models is not
ported yet (ROADMAP queue 1 item 15); the module emits the
``roofline/dryrun_missing`` row, as the JAX module does when it finds no
dry-run records.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Row, timed
from repro_torch.core import distributions as dists, queueing
from repro_torch.core.scenario import Scenario
from repro_torch.device import F32_OPS_PER_S, HBM_BYTES_PER_S
from repro_torch.kernels import dispatch
from repro_torch.kernels.cell_update.ops import cell_update_costs

RIDGE = F32_OPS_PER_S / HBM_BYTES_PER_S  # FLOP/byte: compute overtakes memory


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
    return _cell_update_rows(smoke, device) + [
        ("roofline/dryrun_missing", 0.0,
         "the dry-run cost analysis is not ported yet (ROADMAP queue 1 "
         "item 15)")]

"""Figures 5-11: the disk-backed database study — all seven paper
variants as ONE heterogeneous mixed grid.

Each variant's paper-calibrated storage model is fitted once into a
unit-mean quantile-table ``EmpiricalDist`` (``storage_sim
.empirical_service_dist``), wrapped in a single-dist ``Scenario`` with
its own client overhead, and the whole sequence runs through ONE
``queueing.run`` call: "which storage variant" is just the per-cell
``dist_id`` coordinate, so the seven variants share one ``cell_update``
launch per chunk. Thresholds come from ONE mixed-grid
``threshold.scenario_gain`` call over the load grid — seven gain curves
from one engine execution — read off per variant with
``threshold.crossing_load``."""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Row, timed
from repro_torch.core import queueing, scenario as scn_mod, storage_sim, \
    threshold
from repro_torch.core.scenario import Scenario
from repro_torch.kernels import dispatch

VARIANTS = {
    "fig5_base": storage_sim.StorageConfig(),
    "fig6_small_files": storage_sim.StorageConfig(mean_file_kb=0.04),
    "fig7_pareto_sizes": storage_sim.StorageConfig(file_dist="pareto"),
    "fig8_cache_001": storage_sim.StorageConfig(cache_disk_ratio=0.01),
    "fig9_ec2_variance": storage_sim.StorageConfig(seek_cv=1.5),
    "fig10_400kb": storage_sim.StorageConfig(mean_file_kb=400.0),
    "fig11_in_memory": storage_sim.StorageConfig(cache_disk_ratio=2.0),
}

LOADS = (0.1, 0.2, 0.3, 0.4)


def _rhos(smoke: bool) -> np.ndarray:
    return np.linspace(0.05, 0.495, 8 if smoke else 24, dtype=np.float32)


def compute(smoke: bool = False, kernel: str = "auto", device="cuda",
            mesh=None):
    """({"fits": (dist, ms_scale, overhead) per variant, "summaries": the
    run's summaries, "gain": (B, n_variants)}, microseconds of the two
    engine calls)."""
    variants = dict(list(VARIANTS.items())[:2]) if smoke else VARIANTS
    fits = [storage_sim.empirical_service_dist(scfg, device=device)
            for scfg in variants.values()]
    scns = tuple(Scenario(dists=dist, ks=(1, 2), client_overhead=ovh)
                 for dist, _, ovh in fits)
    cfg = queueing.SimConfig(n_servers=20,
                             n_arrivals=4_000 if smoke else 60_000)

    def work():
        # ONE mixed-grid sweep (percentiles) + ONE mixed-grid gain curve:
        # every storage variant is a dist_id coordinate of the same
        # engine call.
        s = queueing.run(4, scns, LOADS, cfg, n_seeds=1, mesh=mesh,
                         kernel=kernel, device=device)
        g = threshold.scenario_gain(4, scns, _rhos(smoke), cfg, n_seeds=1,
                                    mesh=mesh, kernel=kernel, device=device)
        return s, g

    (s, g), us = timed(work)
    return {"fits": fits, "summaries": s, "gain": g}, us


def run(smoke: bool = False, kernel: str = "auto", device="cuda",
        mesh=None) -> list[Row]:
    resolved = dispatch.resolve(kernel, device)
    mesh_shape = mesh.shape if mesh is not None else None
    out, us = compute(smoke, kernel, device, mesh)
    fits, s, g = out["fits"], out["summaries"], out["gain"]
    rhos = _rhos(smoke)
    rows: list[Row] = []
    for i, (name, (dist, ms_scale, ovh)) in enumerate(zip(VARIANTS, fits)):
        c1, c2 = 2 * i, 2 * i + 1  # paired (k=1, k=2) variant columns
        t = threshold.crossing_load(rhos, g[:, i])
        m1 = float(s["mean"][0, 0, c1]) * ms_scale
        m2 = float(s["mean"][0, 0, c2]) * ms_scale
        p99_1 = float(s["p99"][0, 1, c1]) * ms_scale
        p99_2 = float(s["p99"][0, 1, c2]) * ms_scale
        p999_1 = float(s["p99.9"][0, 0, c1]) * ms_scale
        p999_2 = float(s["p99.9"][0, 0, c2]) * ms_scale
        scn = Scenario(dists=dist, ks=(1, 2), client_overhead=ovh)
        rows.append((f"fig5-11/{name}", us / len(fits),
                     f"threshold={t:.2f};mean@0.1={m1:.2f}->{m2:.2f}ms;"
                     f"p99@0.2={p99_1:.1f}->{p99_2:.1f}ms;"
                     f"p999@0.1_ratio={p999_1 / max(p999_2, 1e-9):.2f}x;"
                     f"overhead_frac={ovh:.3f}",
                     mesh_shape, scn_mod.provenance(scn), resolved))
    return rows

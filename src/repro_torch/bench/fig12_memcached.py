"""Figures 12-13: memcached (in-memory) study — client-side overhead makes
replication a net loss beyond ~10% load; the stub measurement bounds the
overhead at ~9% of mean service.

The memcached service model is fitted once into a unit-mean
quantile-table ``EmpiricalDist`` (``storage_sim.empirical_service_dist``)
and the gain curve comes from one ``threshold.scenario_gain`` engine
call over (seeds x loads x {k=1, k=2}); pass ``chunk_size`` to stream
arrivals through the chunked engine (None runs the stream as one
chunk)."""
from __future__ import annotations

from repro_torch.bench.common import Row, timed
from repro_torch.core import queueing, scenario as scn_mod, storage_sim, \
    threshold
from repro_torch.core.scenario import Scenario
from repro_torch.kernels import dispatch

LOADS = (0.1, 0.3, 0.5, 0.7, 0.9)


def compute(smoke: bool = False, kernel: str = "auto", device="cuda",
            chunk_size: int | None = None, mesh=None):
    """({"fit": (dist, ms_scale, overhead), "gain": (5,)}, microseconds
    of the engine call)."""
    fit = storage_sim.empirical_service_dist(storage_sim.MEMCACHED,
                                             device=device)
    scn = Scenario(dists=fit[0], ks=(1, 2), client_overhead=fit[2])
    cfg = queueing.SimConfig(n_servers=20,
                             n_arrivals=4_000 if smoke else 60_000)
    g, us = timed(lambda: threshold.scenario_gain(
        5, scn, LOADS, cfg, n_seeds=2, chunk_size=chunk_size, mesh=mesh,
        kernel=kernel, device=device))
    return {"fit": fit, "gain": g}, us


def run(smoke: bool = False, chunk_size: int | None = None,
        kernel: str = "auto", device="cuda", mesh=None) -> list[Row]:
    resolved = dispatch.resolve(kernel, device)
    mesh_shape = mesh.shape if mesh is not None else None
    out, us = compute(smoke, kernel, device, chunk_size, mesh)
    (dist, ms_scale, ovh), g = out["fit"], out["gain"]
    prov = scn_mod.provenance(Scenario(dists=dist, ks=(1, 2),
                                       client_overhead=ovh))
    rows: list[Row] = [
        (f"fig12/memcached/rho={rho:.1f}", us / 5,
         f"gain_ms={float(g[i]) * ms_scale:.4f};helps={bool(g[i] > 0)}",
         mesh_shape, prov, resolved)
        for i, rho in enumerate(LOADS)]
    # fig13: the stub version quantifies the client-side overhead fraction
    rows.append(("fig13/stub_overhead", 0.0,
                 f"overhead_frac={ovh:.3f};mean_service_ms={ms_scale:.3f}"))
    return rows

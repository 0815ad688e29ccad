"""Cross-system crossover: disk-backed DB vs memcached vs DNS on ONE
mixed grid.

The paper's three measured systems answer the same question at three
points of the service-time spectrum: where is the load threshold below
which replication helps? Here each system is fitted once into a
unit-mean quantile-table ``EmpiricalDist`` (storage and memcached via
``storage_sim.empirical_service_dist``, DNS via the k=1 fit of
``dns.empirical_k_dists``) and all three ride ONE
``threshold.scenario_gain`` engine call as a heterogeneous mixed grid —
"which system" is the per-cell ``dist_id`` coordinate, so the three
help/hurt curves come out of a single sweep, CRN-paired within each
system. ``threshold.crossing_load`` reads each system's crossover off
its gain column, and the summary row orders them: heavy-tailed disk
crosses latest, overhead-dominated memcached earliest.

A parity row re-runs a smoke-sized grid with ``kernel="off"`` and with
the resolved mode, and records bit-identity of their summaries: on the
card the ``cell_update`` kernel against its plain version; on the CPU,
where there is no kernel, both runs take the plain version."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.common import Row, timed
from repro_torch.core import dns, queueing, scenario as scn_mod, \
    storage_sim, threshold
from repro_torch.core.scenario import Scenario
from repro_torch.kernels import dispatch

SYSTEMS = ("disk", "memcached", "dns")
PARITY_CFG = queueing.SimConfig(n_servers=20, n_arrivals=2_000)
PARITY_RHOS = (0.1, 0.3)


def _fits(device):
    """(dist, ms_scale, overhead) per system, fitted once."""
    disk = storage_sim.empirical_service_dist(storage_sim.StorageConfig(),
                                              device=device)
    mem = storage_sim.empirical_service_dist(storage_sim.MEMCACHED,
                                             device=device)
    d = dns.empirical_k_dists(6, dns.DNSPopulation(), ks=(1,),
                              device=device)[0]
    # replicating a DNS query costs one extra ~0.5 KB packet, not a
    # client-side protocol handshake: no overhead term.
    return [disk, mem, (d, d.scale, 0.0)]


def _rhos(smoke: bool) -> np.ndarray:
    return np.linspace(0.05, 0.495, 8 if smoke else 24, dtype=np.float32)


def _scenarios(fits):
    return tuple(Scenario(dists=dist, ks=(1, 2), client_overhead=ovh)
                 for dist, _, ovh in fits)


def compute(smoke: bool = False, kernel: str = "auto", device="cuda",
            mesh=None):
    """({"fits": (dist, ms_scale, overhead) per system, "gain": (B, 3)},
    microseconds of the engine call)."""
    fits = _fits(device)
    cfg = queueing.SimConfig(n_servers=20,
                             n_arrivals=4_000 if smoke else 60_000)
    # ONE engine call, three systems: gain matrix (B, 3)
    g, us = timed(lambda: threshold.scenario_gain(
        8, _scenarios(fits), _rhos(smoke), cfg, n_seeds=2, mesh=mesh,
        kernel=kernel, device=device))
    return {"fits": fits, "gain": g}, us


def run(smoke: bool = False, kernel: str = "auto", device="cuda",
        mesh=None) -> list[Row]:
    rows: list[Row] = []
    resolved = dispatch.resolve(kernel, device)
    mesh_shape = mesh.shape if mesh is not None else None
    out, us = compute(smoke, kernel, device, mesh)
    fits, g = out["fits"], out["gain"]
    scns, rhos = _scenarios(fits), _rhos(smoke)
    crossings = {}
    for i, name in enumerate(SYSTEMS):
        dist, ms_scale, ovh = fits[i]
        t = threshold.crossing_load(rhos, g[:, i])
        crossings[name] = t
        g_lo, g_hi = float(g[0, i]) * ms_scale, float(g[-1, i]) * ms_scale
        rows.append((f"fig_cross_system/{name}", us / len(SYSTEMS),
                     f"crossover_load={t:.3f};"
                     f"gain@{float(rhos[0]):.2f}={g_lo:.4f}ms;"
                     f"gain@{float(rhos[-1]):.2f}={g_hi:.4f}ms;"
                     f"mean_service_ms={ms_scale:.3f};"
                     f"overhead_frac={ovh:.3f}",
                     mesh_shape, scn_mod.provenance(scns[i]), resolved))
    order = sorted(crossings, key=crossings.get, reverse=True)
    rows.append(("fig_cross_system/crossover", us,
                 ";".join(f"{n}={crossings[n]:.3f}" for n in order)
                 + f";order={'>'.join(order)};"
                 f"rho_grid=[{float(rhos[0]):.2f},{float(rhos[-1]):.2f}]"
                 f"x{rhos.shape[0]}",
                 mesh_shape, scn_mod.provenance(scns), resolved))

    # plain-vs-kernel parity on the mixed grid; smoke-sized — parity is
    # a contract check, not a timing row.
    kw = dict(n_seeds=1, device=device)
    off = queueing.run(8, scns, PARITY_RHOS, PARITY_CFG, kernel="off", **kw)
    on, kus = timed(lambda: queueing.run(8, scns, PARITY_RHOS, PARITY_CFG,
                                         kernel=resolved, **kw))
    bit = all(torch.equal(off[f], on[f]) for f in ("mean", "p50", "p99"))
    rows.append(("fig_cross_system/kernel_parity", kus,
                 f"kernel={resolved};bit_identical={bit};"
                 f"cells={len(PARITY_RHOS) * 2 * len(scns)};"
                 f"arrivals={PARITY_CFG.n_arrivals}",
                 None, scn_mod.provenance(scns), resolved))
    return rows

"""Policy-space figure: Shah et al.'s headline crossover on the scenario
engine — replication (k=2, replicate-all) helps exponential service at a
load below the paper's 1/3 threshold under i.i.d. service, but HURTS once
service times are server-dependent (the request-component ``mix`` -> 1
collapses the threshold toward ~0.28), while Joshi-style cancellation
(``CANCEL_ON_COMPLETE``) keeps replication profitable at every probed
load.

The whole (policy x model x mix x k x load) grid is ONE mixed-policy
``queueing.run`` call — every variant rides the same cell plan and the
same ``cell_update`` launch per chunk on the card (the plain version
under ``kernel="off"``, bit-identical). Each row carries its scenario
and the RESOLVED kernel mode as JSON provenance.

Emits one row per scenario (CRN-paired gain at each probe load) plus a
``fig_policy_space/crossover`` summary row asserting the headline:
``gain_iid > 0 > gain_server_dependent`` at the probe load between the
two thresholds."""
from __future__ import annotations

from repro_torch.bench.common import Row, timed
from repro_torch.core import distributions as dists
from repro_torch.core import queueing, scenario as scn_mod
from repro_torch.core.scenario import (CANCEL_ON_COMPLETE, SERVER_DEPENDENT,
                                       Scenario)
from repro_torch.kernels import dispatch

CFG = queueing.SimConfig(n_servers=20, n_arrivals=200_000)
CHUNK = 4_096
# 0.15: replication helps everywhere it is stable; 0.30: between the
# server-dependent threshold (~0.28 at mix=1) and the paper's 1/3.
RHOS = (0.15, 0.30)
MIXES = (0.5, 1.0)


def _scenarios() -> list[tuple[str, Scenario]]:
    d = dists.exponential()
    entries = [("iid", Scenario.paper_default(d, ks=(1, 2)))]
    for mx in MIXES:
        entries.append((f"server_dep_mix{mx:g}",
                        Scenario(dists=d, service_model=SERVER_DEPENDENT,
                                 mix=mx, ks=(1, 2))))
    entries.append(("cancel",
                    Scenario(dists=d, policy=CANCEL_ON_COMPLETE,
                             ks=(1, 2))))
    return entries


def compute(smoke: bool = False, kernel: str = "auto", device="cuda",
            mesh=None):
    """(the mixed grid's summaries, microseconds)."""
    cfg = (queueing.SimConfig(n_servers=20, n_arrivals=6_000) if smoke
           else CFG)
    return timed(lambda: queueing.run(
        2, tuple(s for _, s in _scenarios()), RHOS, cfg,
        n_seeds=2 if smoke else 3, percentiles=(), chunk_size=CHUNK,
        mesh=mesh, kernel=kernel, device=device))


def run(smoke: bool = False, kernel: str = "auto", device="cuda",
        mesh=None) -> list[Row]:
    resolved = dispatch.resolve(kernel, device)
    mesh_shape = mesh.shape if mesh is not None else None
    entries = _scenarios()
    out, total_us = compute(smoke, kernel, device, mesh)
    n_seeds = out["mean"].shape[0]
    m = out["mean"].mean(dim=0)  # (B, 2 * n_scenarios)

    rows: list[Row] = []
    gains = {}
    for j, (name, scn) in enumerate(entries):
        g = {r: float(m[i, 2 * j] - m[i, 2 * j + 1])
             for i, r in enumerate(RHOS)}
        gains[name] = g
        derived = ";".join(f"gain@rho{r:g}={v:+.4f}" for r, v in g.items())
        rows.append((f"fig_policy_space/{name}", total_us / len(entries),
                     derived, mesh_shape, scn_mod.provenance(scn),
                     resolved))

    # the headline: between the thresholds, IID helps and
    # server-dependence flips the sign; cancellation helps everywhere.
    rho_x = RHOS[-1]
    crossover = (gains["iid"][rho_x] > 0.0
                 > gains[f"server_dep_mix{MIXES[-1]:g}"][rho_x])
    rows.append(("fig_policy_space/crossover", total_us,
                 f"rho={rho_x};crossover={crossover};"
                 f"cancel_helps_everywhere="
                 f"{all(v > 0 for v in gains['cancel'].values())};"
                 f"scenarios={len(entries)};seeds={n_seeds}",
                 mesh_shape, None, resolved))
    return rows

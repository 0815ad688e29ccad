"""Sweep-engine speedup + chunk-streaming benchmarks.

Part 1 — the old sequential path vs the fused engine on the Figure 2
threshold sweep (15 service-time families). The "old" path is the JAX
package's pre-refactor reference: ``simulate_grid`` over every load, one
call per (seed, k), from Python — ``2 * n_seeds`` full passes per
distribution, each arrival one ``cell_update.ref.step_cell`` call paced
by the host (``queueing._scan_sim``). The fused path estimates ALL
families' thresholds from one engine call
(``threshold.threshold_grid_batch``, ``cell_update`` on the card). Both
read the same streams (seed row ``s`` of the fused run is
``simulate_grid(..., row=s)``), so the thresholds agree to the Kahan
sum's rounding: ``max_threshold_delta`` reads about 0.000.

Part 2 — chunk-streamed vs pre-sampled engine: the same thresholds via
``chunk_size=4096`` (they must match within the load-grid step), wall
clock for both, and the randomness-input footprint each path holds (the
chunked path's is independent of ``n_arrivals``). Finishes with a
streamed sweep of 2M arrivals.

Part 3 — the sharded cell-plan executor (``mesh``) is not ported yet
(ROADMAP queue 1 item 13): ``run(mesh=...)`` raises, as
``queueing.run(mesh=...)`` does.

Part 4 — ``cell_update`` kernel on vs off: the same chunked sweep through
the plain version (``kernel="off"``) and through the kernel (the
resolved mode), wall clock both ways, bit-identity recorded. On the CPU,
where there is no kernel, both legs are the plain version.

Part 5 — sampling pipeline on vs off (``queueing.run``'s ``pipeline``):
the large streamed sweep with serial per-chunk sampling vs the producer
thread, wall clock both ways, bit-identity recorded.

At ``smoke`` size the streamed sweeps of parts 2 and 5 take 20k
arrivals (the JAX module's smoke takes 200k): the plain version that
runs them on the CPU steps one arrival at a time.

``python -m repro_torch.bench.sweep_engine`` times part 1's old path for
one family at full size (pareto 6: 24 loads x 2 seeds x k in {1, 2}, 50k
arrivals), the cost that ``chip_smoke.py`` avoids by running this module
at its smoke size.

Emits per-family rows plus ``sweep_engine/total``,
``sweep_engine/chunked*``, ``sweep_engine/kernel_on_vs_off`` and
``sweep_engine/pipeline_on_vs_off``."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.bench.common import Row
from repro_torch.core import distributions as dists
from repro_torch.core import queueing, scenario as scn_mod, threshold
from repro_torch.core.scenario import Scenario
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch

CFG = queueing.SimConfig(n_servers=20, n_arrivals=50_000)
FAMILY_PARAMS = {
    "pareto": (6.0, 3.0, 2.5, 2.2, 2.05),
    "weibull": (2.0, 1.0, 0.7, 0.5, 0.4),
    "two_point": (0.1, 0.5, 0.8, 0.95, 0.99),
}
CHUNK = 4096
SEED = 1


def _paper_provenance(dist, ks=(1, 2)):
    """Scenario provenance of a paper-default sweep row."""
    return scn_mod.provenance(Scenario.paper_default(dist, ks=ks))


def _entries(smoke: bool):
    params = ({fam: ps[:1] for fam, ps in FAMILY_PARAMS.items()} if smoke
              else FAMILY_PARAMS)
    return [(fam, x, dists.FAMILIES[fam](x))
            for fam, ps in params.items() for x in ps]


def _cfg(smoke: bool) -> queueing.SimConfig:
    """Parts 1, 2 and 4's arrivals: 50k, 5k at smoke size."""
    return queueing.SimConfig(n_servers=20, n_arrivals=5_000) if smoke \
        else CFG


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _threshold_grid_reference(seed, dist, cfg, *, k=2, rhos=None,
                              n_seeds=2, device="cuda") -> float:
    """The pre-refactor path: python loops of ``simulate_grid`` over
    seeds x {1, k}, then crossing interpolation."""
    rhos = threshold.default_rhos() if rhos is None else rhos
    gains = []
    for s in range(n_seeds):
        r1 = queueing.simulate_grid(seed, dist, rhos, cfg, 1, row=s,
                                    device=device)
        rk = queueing.simulate_grid(seed, dist, rhos, cfg, k, row=s,
                                    device=device)
        gains.append(queueing._warm(r1, cfg).mean(dim=-1)
                     - queueing._warm(rk, cfg).mean(dim=-1))
    g = torch.stack(gains).mean(dim=0).cpu().numpy()
    return threshold.crossing_load(rhos, g)


def _input_bytes(n: int, k_max: int = 2) -> int:
    """Bytes of pre-sampled randomness per seed for ``n`` arrivals: one f32
    gap + k_max i32 servers + k_max f32 services per arrival."""
    return n * 4 * (1 + 2 * k_max)


def _bit_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[f], b[f]) for f in ("mean", "p50", "p99"))


def _big_cfg(smoke: bool) -> queueing.SimConfig:
    return queueing.SimConfig(n_servers=20,
                              n_arrivals=20_000 if smoke else 2_000_000)


def _kernel_rows(cfg: queueing.SimConfig, smoke: bool, device) -> list[Row]:
    """``cell_update`` on vs off on the same chunked sweep: wall clock for
    each, bit-identity recorded, the measured speedup in the derived
    field."""
    mode = dispatch.resolve("auto", device)  # "on" on the card
    scn = Scenario.paper_default(dists.exponential(), ks=(1, 2))
    rhos = np.linspace(0.1, 0.4, 3, dtype=np.float32)
    kcfg = (cfg if smoke
            else queueing.SimConfig(n_servers=20, n_arrivals=20_000))
    legs, secs = {}, {}
    for label, m in (("off", "off"), ("on", mode)):
        t0 = time.perf_counter()
        legs[label] = queueing.run(SEED, scn, rhos, kcfg, n_seeds=2,
                                   chunk_size=CHUNK, kernel=m, device=device)
        _sync()
        secs[label] = time.perf_counter() - t0
    scan_s, kernel_s = secs["off"], secs["on"]
    return [("sweep_engine/kernel_on_vs_off", kernel_s * 1e6,
             f"kernel={mode};arrivals={kcfg.n_arrivals};"
             f"scan_s={scan_s:.2f};kernel_s={kernel_s:.2f};"
             f"speedup={scan_s / kernel_s:.2f}x;"
             f"bit_identical={_bit_equal(legs['off'], legs['on'])}",
             None, scn_mod.provenance(scn), mode)]


def _pipeline_rows(kernel: str, smoke: bool, device) -> list[Row]:
    """Sampling pipeline on vs off on the large streamed sweep: wall clock
    both ways, bit-identity recorded in the derived field."""
    resolved = dispatch.resolve(kernel, device)
    big_cfg = _big_cfg(smoke)
    scn = Scenario.paper_default(dists.exponential(), ks=(1, 2))
    legs, secs = {}, {}
    for pipe in ("off", "on"):
        t0 = time.perf_counter()
        legs[pipe] = queueing.run(SEED, scn, [0.3], big_cfg, n_seeds=1,
                                  chunk_size=CHUNK, kernel=kernel,
                                  pipeline=pipe, device=device)
        _sync()
        secs[pipe] = time.perf_counter() - t0
    off_s, on_s = secs["off"], secs["on"]
    return [("sweep_engine/pipeline_on_vs_off", on_s * 1e6,
             f"arrivals={big_cfg.n_arrivals};chunk={CHUNK};off_s={off_s:.2f};"
             f"on_s={on_s:.2f};speedup={off_s / on_s:.2f}x;"
             f"bit_identical={_bit_equal(legs['off'], legs['on'])}",
             None, scn_mod.provenance(scn), resolved)]


def old_path(smoke: bool, device="cuda") -> tuple[list[float], list[float]]:
    """Part 1's old path over the families: (thresholds, microseconds of
    each family)."""
    cfg = _cfg(smoke)
    ths, us = [], []
    for _, _, dist in _entries(smoke):
        t0 = time.perf_counter()
        ths.append(_threshold_grid_reference(SEED, dist, cfg, n_seeds=2,
                                             device=device))
        us.append((time.perf_counter() - t0) * 1e6)
    return ths, us


def run(smoke: bool = False, kernel: str = "auto", device="cuda",
        mesh=None) -> list[Row]:
    if mesh is not None:
        raise NotImplementedError(queueing.MESH_NOT_PORTED)
    rows: list[Row] = []
    dev = resolve_device(device)
    cfg = _cfg(smoke)
    resolved = dispatch.resolve(kernel, dev)
    entries = _entries(smoke)

    # --- old path: simulate_grid per (family, seed, k) --------------------
    t0 = time.perf_counter()
    old_ths, old_us = old_path(smoke, dev)
    old_total = time.perf_counter() - t0

    # --- fused path: every family in ONE engine call ---------------------
    t0 = time.perf_counter()
    new_ths = threshold.threshold_grid_batch(
        SEED, [dist for _, _, dist in entries], cfg, n_seeds=2,
        kernel=kernel, device=dev)
    new_total = time.perf_counter() - t0
    new_us = new_total * 1e6 / len(entries)

    max_delta = 0.0
    for (fam, x, _), t_old, t_new, us in zip(entries, old_ths, new_ths,
                                             old_us):
        max_delta = max(max_delta, abs(t_old - t_new))
        rows.append((f"sweep_engine/{fam}/x={x:g}", us,
                     f"old={t_old:.3f};fused={t_new:.3f};"
                     f"speedup={us / new_us:.1f}x"))
    rows.append(("sweep_engine/total", old_total * 1e6,
                 f"old_s={old_total:.2f};fused_s={new_total:.2f};"
                 f"speedup={old_total / new_total:.1f}x;"
                 f"max_threshold_delta={max_delta:.4f}"))

    # --- chunked vs pre-sampled: thresholds must agree within the load
    # grid's interpolation tolerance (grid step ~0.02) ---------------------
    rhos = threshold.default_rhos()
    grid_step = float(rhos[1] - rhos[0])
    chunk_delta = 0.0
    for dist in (dists.exponential(), dists.pareto(2.2)):
        secs, ths = {}, {}
        for label, chunk in (("un", None), ("ch", CHUNK)):
            t0 = time.perf_counter()
            ths[label] = threshold.threshold_grid(
                SEED, dist, cfg, rhos=rhos, n_seeds=2, chunk_size=chunk,
                kernel=kernel, device=dev)
            secs[label] = time.perf_counter() - t0
        delta = abs(ths["un"] - ths["ch"])
        chunk_delta = max(chunk_delta, delta)
        rows.append((f"sweep_engine/chunked/{dist.name}", secs["ch"] * 1e6,
                     f"unchunked={ths['un']:.3f};chunked={ths['ch']:.3f};"
                     f"delta={delta:.4f};tol={grid_step:.3f};"
                     f"match={delta <= grid_step};"
                     f"unchunked_s={secs['un']:.2f};"
                     f"chunked_s={secs['ch']:.2f}",
                     None, _paper_provenance(dist), resolved))

    # --- streamed large-n_arrivals sweep: the input footprint is set by
    # chunk_size, not n_arrivals -------------------------------------------
    big_cfg = _big_cfg(smoke)
    big_m = big_cfg.n_arrivals
    scn_big = Scenario.paper_default(dists.exponential(), ks=(1, 2))
    t0 = time.perf_counter()
    out = queueing.run(SEED, scn_big, [0.3], big_cfg, n_seeds=1,
                       chunk_size=CHUNK, kernel=kernel, device=dev)
    _sync()
    big_s = time.perf_counter() - t0
    rows.append((f"sweep_engine/chunked_{big_m // 1000}k", big_s * 1e6,
                 f"chunk={CHUNK};mean_k1={float(out['mean'][0, 0, 0]):.4f};"
                 f"p99_k2={float(out['p99'][0, 0, 1]):.3f};"
                 f"input_kb_chunked={_input_bytes(CHUNK) // 1024};"
                 f"input_kb_presampled={_input_bytes(big_m) // 1024};"
                 f"arrivals_per_s={big_m / big_s:.0f}",
                 None, _paper_provenance(dists.exponential()), resolved))
    rows.append(("sweep_engine/chunked_total", 0.0,
                 f"max_threshold_delta={chunk_delta:.4f};"
                 f"interp_tol={grid_step:.3f}"))

    rows.extend(_kernel_rows(cfg, smoke, dev))
    rows.extend(_pipeline_rows(kernel, smoke, dev))
    return rows


def main(argv: list[str] | None = None) -> float:
    """Time the old path of the first family (pareto 6) at full size, or
    at smoke size with ``--smoke``; returns the seconds."""
    from repro_torch.bench.run import card_line

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = _cfg(args.smoke)
    fam, x, dist = _entries(args.smoke)[0]
    _sync()
    t0 = time.perf_counter()
    th = _threshold_grid_reference(SEED, dist, cfg, device=dev)
    _sync()
    secs = time.perf_counter() - t0
    print(f"sweep_engine old path, {fam} {x:g}: 24 loads x 2 seeds x k in "
          f"{{1, 2}} at {cfg.n_arrivals} arrivals, host-paced simulate_grid: "
          f"{secs}s, threshold {th}; {card_line(dev)}")
    return secs


if __name__ == "__main__":
    main()

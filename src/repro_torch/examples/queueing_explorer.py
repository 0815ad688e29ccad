"""Explore the replication policy space interactively from the CLI: pick a
service-time family, a replication policy and a service model, and sweep
loads / replication factors.

The whole (load x k) table comes from ONE ``queueing.run`` call executing
a declarative ``Scenario`` (policy, service model, mix, ks).

Run (on the card; add ``--device cpu`` for the plain path on the CPU):

    PYTHONPATH=src python -m repro_torch.examples.queueing_explorer \\
        --family pareto --param 2.1 --k 1 2 3

``--policy cancel_on_complete`` switches to the Joshi et al. regime
(losers vacate their queue slot at the winner's finish),
``--policy replicate_to_idle`` only copies to idle servers, and
``--service-model server_dependent --mix 0.8`` blends Shah et al.'s
shared request component into every copy's service time (replication
stops helping as ``--mix`` approaches 1).

``--chunk-size`` streams arrivals through the chunked engine so
``--arrivals`` can go into the millions without pre-sampling the whole
stream (the default, no chunking, samples it at once).

``--devices N`` asks for the sharded cell-plan executor, which is not
ported yet: it raises (``queueing.MESH_NOT_PORTED``).

``--kernel {auto,on,off}`` picks the engine's chunk body: the
``cell_update`` kernel or its plain version (``auto`` = the kernel on the
card, the plain version on the CPU; the two are bit-identical).
"""
from __future__ import annotations

import argparse

from repro_torch.core import distributions as dists
from repro_torch.core import queueing, threshold
from repro_torch.core.scenario import (Policy, Scenario, ServiceModel,
                                       parse_policy, parse_service_model)
from repro_torch.kernels import dispatch


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="exponential",
                    choices=sorted(dists.FAMILIES))
    ap.add_argument("--param", type=float, default=None,
                    help="family parameter (pareto alpha / weibull k / "
                         "two_point p)")
    ap.add_argument("--k", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--loads", type=float, nargs="+",
                    default=[0.1, 0.2, 0.3, 0.4])
    ap.add_argument("--servers", type=int, default=20)
    ap.add_argument("--arrivals", type=int, default=60_000)
    ap.add_argument("--policy", default="replicate_all",
                    choices=[p.name.lower() for p in Policy],
                    help="replication policy (paper: replicate_all)")
    ap.add_argument("--service-model", default="iid",
                    choices=[m.name.lower() for m in ServiceModel],
                    help="copy service-time model (paper: iid)")
    ap.add_argument("--mix", type=float, default=0.5,
                    help="server_dependent only: fraction of each copy's "
                         "service time that is the shared request "
                         "component (0 = iid, 1 = fully request-bound)")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="stream arrivals in chunks of this many steps "
                         "(memory independent of --arrivals)")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard the sweep's cells over this many devices "
                         "(not ported yet: raises)")
    ap.add_argument("--kernel", default="auto", choices=dispatch.KERNEL_MODES,
                    help="cell_update kernel mode (auto: the kernel on the "
                         "card, the plain version on the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.devices:
        raise NotImplementedError(queueing.MESH_NOT_PORTED)

    factory = dists.FAMILIES[args.family]
    dist = factory(args.param) if args.param is not None else factory()
    cfg = queueing.SimConfig(n_servers=args.servers,
                             n_arrivals=args.arrivals)
    scn = Scenario(dists=dist, policy=parse_policy(args.policy),
                   service_model=parse_service_model(args.service_model),
                   mix=args.mix, ks=tuple(args.k))
    kernel = dispatch.resolve(args.kernel, args.device)

    # one engine call over all (load, k) cells of the scenario
    s = queueing.run(0, scn, args.loads, cfg, n_seeds=1,
                     chunk_size=args.chunk_size, kernel=kernel,
                     device=args.device)

    model = scn.service_model.name.lower()
    if scn.service_model is ServiceModel.SERVER_DEPENDENT:
        model += f"(mix={scn.mix:g})"
    print(f"service = {dist.name}, N = {args.servers}, "
          f"policy = {scn.policy.name.lower()}, model = {model}, "
          f"kernel = {kernel}, device = {args.device}")
    print("load  " + "  ".join(f"k={k}: mean/p99" for k in args.k))
    for i, rho in enumerate(args.loads):
        cells = [f"{float(s['mean'][0, i, j]):7.3f}/"
                 f"{float(s['p99'][0, i, j]):8.2f}"
                 for j in range(len(args.k))]
        print(f"{float(rho):.2f} " + "  ".join(cells))

    t = threshold.threshold_grid(0, scn, cfg, n_seeds=2,
                                 chunk_size=args.chunk_size, kernel=kernel,
                                 device=args.device)
    print(f"\nestimated threshold load (k=2): {t:.3f} "
          f"(paper model: always in ~(0.26, 0.5) with no client overhead)")
    return {"summary": s, "threshold": t}


if __name__ == "__main__":
    main()

"""Replicated DNS queries (paper §3.2).

Elastic-resource ("individual view") model: servers are public resolvers
whose load we do not influence, so there is no queueing — each server i has a
stationary response-time distribution and queries to different servers are
independent apart from a shared client/access-link component (which is what
keeps the k=10 tail from vanishing to zero, matching the paper's measured
6.5x / 50x — not 10^6x — tail reductions).

  response_i = shared + base_i + Exp(jitter_i),  or TIMEOUT w.p. loss_i
  shared     = 0 w.p. 1-p_shared, else Exp(shared_ms)

A query replicated to servers S completes at min_{i in S} response_i, and
anything above 2 s counts as 2 s (the paper treats >2 s as lost).

The PyTorch port of ``repro.core.dns``: draws come from the
``torch.Generator`` a function is given, on its device; the population
and the reductions are the JAX package's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import distributions
from repro_torch.device import resolve_device, seeded_generator

TIMEOUT_MS = 2000.0


@dataclasses.dataclass(frozen=True)
class DNSServer:
    base_ms: float
    jitter_ms: float
    loss: float


# A 10-resolver population loosely calibrated so that the *best single
# server* has mean ~= 50-70 ms with a ~1-2% >500 ms tail — the regime of the
# paper's PlanetLab measurement (local resolver + 9 public services).
DEFAULT_SERVERS: tuple[DNSServer, ...] = (
    DNSServer(12.0, 25.0, 0.010),   # local resolver: fast but lossy-ish
    DNSServer(18.0, 30.0, 0.008),
    DNSServer(22.0, 35.0, 0.006),
    DNSServer(25.0, 45.0, 0.008),
    DNSServer(30.0, 50.0, 0.010),
    DNSServer(35.0, 60.0, 0.012),
    DNSServer(40.0, 70.0, 0.010),
    DNSServer(55.0, 90.0, 0.015),
    DNSServer(70.0, 110.0, 0.015),
    DNSServer(90.0, 140.0, 0.020),
)


@dataclasses.dataclass(frozen=True)
class DNSPopulation:
    servers: tuple[DNSServer, ...] = DEFAULT_SERVERS
    p_shared: float = 0.02          # access-link congestion episodes
    shared_ms: float = 250.0
    query_bytes: int = 500          # per paper's cost arithmetic (~0.5 KB)


def _shared_ms(gen: torch.Generator, pop: DNSPopulation,
               n: int) -> torch.Tensor:
    """(n, 1) shared client/access-link component per query."""
    dev = gen.device
    on = torch.rand((n, 1), generator=gen, device=dev) < pop.p_shared
    exp = torch.empty((n, 1), device=dev).exponential_(generator=gen)
    return torch.where(on, exp * pop.shared_ms, 0.0)


def sample_latencies(gen: torch.Generator, pop: DNSPopulation,
                     n: int) -> torch.Tensor:
    """(n, n_servers) per-query per-server response times in ms (float32),
    on the generator's device."""
    dev = gen.device
    ns = len(pop.servers)
    shared = _shared_ms(gen, pop, n)

    def per_server(field):
        return torch.tensor([getattr(s, field) for s in pop.servers],
                            dtype=torch.float32, device=dev)[None, :]

    jit = torch.empty((n, ns), device=dev).exponential_(generator=gen)
    lat = per_server("base_ms") + jit * per_server("jitter_ms")
    lost = torch.rand((n, ns), generator=gen, device=dev) < per_server("loss")
    lat = torch.where(lost, TIMEOUT_MS, lat + shared)
    return torch.clamp(lat, max=TIMEOUT_MS)


def rank_table(lat: torch.Tensor) -> torch.Tensor:
    """Server indices by mean response over a latency table, fastest
    first (a stable sort, as ``jnp.argsort``)."""
    return torch.argsort(lat.mean(dim=0), stable=True)


def rank_servers(gen: torch.Generator, pop: DNSPopulation,
                 n_probe: int = 20000) -> torch.Tensor:
    """Stage 1 of the paper's experiment: rank servers by mean response."""
    return rank_table(sample_latencies(gen, pop, n_probe))


def replicated_response(lat: torch.Tensor, ranking: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Stage 2: query the top-k ranked servers in parallel, take the min."""
    top = ranking[:k]
    return lat[:, top].amin(dim=1)


def empirical_k_dists(seed: int, pop: DNSPopulation, ks=range(1, 11), *,
                      n_samples: int = 200_000, n_quantiles: int = 512,
                      device="cuda"
                      ) -> tuple[distributions.EmpiricalDist, ...]:
    """Fit one unit-mean quantile-table ``EmpiricalDist`` per replication
    level: rank the population once (generator ``(seed, 0)``), sample one
    shared latency table (generator ``(seed, 1)``), and fit
    ``distributions.empirical`` on ``min`` over the top-k servers for
    each ``k``. Fitting the *min* (rather than composing per-server fits)
    preserves the shared-component correlation that bounds the k=10
    tail. The fits are engine food — the Fig 15 benchmark runs all ten as
    one heterogeneous mixed grid, and each fit's ``.scale`` recovers
    milliseconds."""
    dev = resolve_device(device)
    ranking = rank_servers(seeded_generator((seed, 0), dev), pop)
    lat = sample_latencies(seeded_generator((seed, 1), dev), pop,
                           int(n_samples))
    return tuple(
        distributions.empirical(
            replicated_response(lat, ranking, k).cpu().numpy(),
            n_quantiles=n_quantiles, name=f"dns(k={int(k)})")
        for k in ks)


def marginal_savings_ms_per_kb(means, pop: DNSPopulation):
    """Fig 17: mean saving of the (k+1)-th server per KB of extra traffic."""
    extra_kb = pop.query_bytes / 1024.0
    return (means[:-1] - means[1:]) / extra_kb

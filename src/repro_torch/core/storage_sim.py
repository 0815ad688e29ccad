"""Service-time models for the paper's storage studies (§2.2 disk-backed DB,
§2.3 memcached).

These produce a unit-mean ``ServiceDist`` + a normalized client-side
duplication overhead so they can be run straight through the §2.1 queueing
simulator; `ms_scale` converts results back to milliseconds for reporting.

Model: a request for a file of size s (KB) is
  * a cache hit  w.p. h: service = mem_base + s / mem_bw
  * a cache miss w.p. 1-h: service = seek (variable) + s / disk_bw
and the client pays (client_base + s * client_per_kb) extra latency per
duplicated request (NIC/kernel/CPU processing of the second copy), which is
the §2.1 "client-side overhead" knob. With 4 KB files that overhead is ~1% of
mean service (replication wins, Fig 5); with 400 KB files or an all-in-memory
store it is a large fraction (replication stops helping, Figs 10-12).

The PyTorch port of ``repro.core.storage_sim``: draws come from the
``torch.Generator`` a sampler is given (size, hit and seek in that order,
on the generator's device), and the configurations and closed forms are
the JAX package's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import distributions
from repro_torch.core.distributions import ServiceDist
from repro_torch.device import resolve_device, seeded_generator


@dataclasses.dataclass(frozen=True)
class StorageConfig:
    mean_file_kb: float = 4.0
    file_dist: str = "deterministic"     # deterministic | pareto
    file_pareto_alpha: float = 2.1
    cache_disk_ratio: float = 0.1        # cache size / total data size
    seek_ms: float = 8.0                 # mean disk seek+rotate
    seek_cv: float = 0.5                 # coefficient of variation of seek
    disk_kb_per_ms: float = 50.0         # ~50 MB/s sequential
    mem_base_ms: float = 0.15
    mem_kb_per_ms: float = 2000.0        # ~2 GB/s
    client_base_ms: float = 0.02
    client_ms_per_kb: float = 0.016      # gigabit NIC + kernel processing

    @property
    def hit_rate(self) -> float:
        # cache:disk ratio r => cache holds r/(1) of the data when r < 1
        # (uniform access => hit rate r); r >= 1 => everything fits.
        return min(1.0, self.cache_disk_ratio)


MEMCACHED = StorageConfig(
    mean_file_kb=0.1, cache_disk_ratio=2.0, mem_base_ms=0.18,
    mem_kb_per_ms=2000.0, client_base_ms=0.016, client_ms_per_kb=0.0)


def _sample_ms(cfg: StorageConfig, gen: torch.Generator,
               shape: tuple[int, ...]) -> torch.Tensor:
    """Service times in ms (float32), on the generator's device."""
    dev = gen.device

    def uniform():
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float32)

    if cfg.file_dist == "deterministic":
        size = torch.full(shape, cfg.mean_file_kb, device=dev,
                          dtype=torch.float32)
    elif cfg.file_dist == "pareto":
        a = cfg.file_pareto_alpha
        xm = (a - 1.0) / a * cfg.mean_file_kb
        size = xm * uniform().clamp_(min=distributions._TINY).pow(-1.0 / a)
    else:  # pragma: no cover - config error
        raise ValueError(f"unknown file_dist {cfg.file_dist}")
    hit = uniform() < cfg.hit_rate
    # seek with mean seek_ms and CV seek_cv: Gamma(1/cv^2) * seek_ms*cv^2
    # (non-negative for ANY cv, e.g. fig9's seek_cv=1.5)
    if cfg.seek_cv == 0.0:
        seek = torch.full(shape, cfg.seek_ms, device=dev,
                          dtype=torch.float32)
    else:
        a = 1.0 / cfg.seek_cv**2
        alpha = torch.full(shape, a, device=dev, dtype=torch.float32)
        seek = torch._standard_gamma(alpha, generator=gen) * (cfg.seek_ms / a)
    t_mem = cfg.mem_base_ms + size / cfg.mem_kb_per_ms
    t_disk = seek + size / cfg.disk_kb_per_ms
    return torch.where(hit, t_mem, t_disk)


def mean_service_ms(cfg: StorageConfig) -> float:
    h = cfg.hit_rate
    t_mem = cfg.mem_base_ms + cfg.mean_file_kb / cfg.mem_kb_per_ms
    t_disk = cfg.seek_ms + cfg.mean_file_kb / cfg.disk_kb_per_ms
    return h * t_mem + (1.0 - h) * t_disk


def client_overhead_ms(cfg: StorageConfig) -> float:
    return cfg.client_base_ms + cfg.client_ms_per_kb * cfg.mean_file_kb


def _name(cfg: StorageConfig) -> str:
    return (f"storage(file={cfg.mean_file_kb:g}KB,{cfg.file_dist},"
            f"cache={cfg.cache_disk_ratio:g})")


def service_dist(cfg: StorageConfig) -> tuple[ServiceDist, float, float]:
    """(unit-mean ServiceDist, ms_scale, normalized client overhead).

    Feed the ServiceDist + overhead into a ``Scenario`` (or
    ``queueing.SimConfig``); multiply simulated responses by ms_scale to
    get milliseconds. The sampler draws the model itself on every call
    (the engine hands it each column's generator), like any other
    closed-form family.
    """
    scale = mean_service_ms(cfg)

    def sample(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
        return _sample_ms(cfg, gen, shape) / scale

    dist = ServiceDist(_name(cfg), sample)
    overhead = client_overhead_ms(cfg) / scale
    return dist, scale, overhead


def empirical_service_dist(cfg: StorageConfig, seed: int = 0, *,
                           n_samples: int = 200_000,
                           n_quantiles: int = 512, device="cuda",
                           ) -> tuple[distributions.EmpiricalDist, float,
                                      float]:
    """Quantile-table twin of ``service_dist``: fit a unit-mean
    ``EmpiricalDist`` to ``_sample_ms`` draws (from a generator of
    ``seed`` on ``device``) so the storage system rides the engine's
    per-cell dist_id coordinate (and the kernel) like any other
    distribution.

    Returns ``(dist, ms_scale, normalized client overhead)`` where
    ``ms_scale == dist.scale`` is the fitted sample mean in ms.
    """
    gen = seeded_generator((seed,), resolve_device(device))
    ms = _sample_ms(cfg, gen, (int(n_samples),))
    dist = distributions.empirical(ms.cpu().numpy(), n_quantiles=n_quantiles,
                                   name=_name(cfg))
    return dist, dist.scale, client_overhead_ms(cfg) / dist.scale

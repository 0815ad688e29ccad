"""Service-time distributions for the replication queueing model (paper §2.1).

Every distribution is normalized to UNIT MEAN so that per-server utilization
equals the arrival rate per server (rho). The families are exactly the
ones the paper studies: exponential (Theorem 1), deterministic (Conjecture 1
worst case), Pareto / Weibull / two-point (Figure 2), random discrete
(Figure 3), plus mixtures and fitted empirical tables.

A ``ServiceDist.sample(gen, shape)`` draws float32 values on the device
of the ``torch.Generator`` it is given, so the engine's explicit
generator streams (see ``repro_torch.core.queueing``) are the only source
of randomness. Torch's Philox and JAX's threefry give different numbers
for the same seed: the port is held to the JAX package by moments,
closed forms and injected inputs, never by draws.

Empirical distributions
-----------------------
``empirical`` turns ANY sample set into a unit-mean quantile-table
``EmpiricalDist``: n+1 quantile knots q_0..q_n fitted at the evenly
spaced probabilities u_i = i/n, sampled by inverse-CDF with linear
interpolation between knots (so the fitted law is the piecewise-linear
CDF through the knots; mean and variance have closed forms over the
table). The original sample mean is kept as ``.scale`` so engine output
(unit-mean time) maps back to milliseconds, and ``.exceedance(x)``
reads tail fractions straight off the table. The fit is float64 numpy,
so it reproduces the JAX package's knots from the same samples.

Identity: factories with hashable scalar parameters (``exponential``,
``deterministic``, ``pareto``, ``weibull``, ``two_point``, ``scaled``)
are memoized, so ``pareto(2.1) is pareto(2.1)`` holds and
``scenario.combine`` dedupes equal systems of a mixed grid.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Callable

import numpy as np
import torch

Sampler = Callable[[torch.Generator, tuple[int, ...]], torch.Tensor]

_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class ServiceDist:
    """A unit-mean service-time distribution."""

    name: str
    sample: Sampler
    mean: float = 1.0
    variance: float | None = None  # None = infinite / not in closed form

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ServiceDist({self.name})"


def _uniform(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 uniforms in [0, 1) on the generator's device."""
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)


def _inverse_cdf(u: torch.Tensor, probs: tuple[float, ...]) -> torch.Tensor:
    """Category index per uniform ``u`` for the discrete law ``probs``."""
    cdf = torch.tensor(np.cumsum(probs), dtype=torch.float32,
                       device=u.device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=len(probs) - 1)


@functools.lru_cache(maxsize=None)
def exponential() -> ServiceDist:
    """Exp(1): the analytically tractable case of Theorem 1."""

    def sample(gen, shape):
        return torch.empty(shape, device=gen.device,
                           dtype=torch.float32).exponential_(generator=gen)

    return ServiceDist("exponential", sample, variance=1.0)


@functools.lru_cache(maxsize=None)
def deterministic() -> ServiceDist:
    """Unit point mass — the paper's conjectured worst case (threshold ~25.8%)."""

    def sample(gen, shape):
        return torch.ones(shape, device=gen.device, dtype=torch.float32)

    return ServiceDist("deterministic", sample, variance=0.0)


@functools.lru_cache(maxsize=None)
def pareto(alpha: float) -> ServiceDist:
    """Unit-mean Pareto with tail index ``alpha`` (> 1).

    x_m = (alpha - 1) / alpha so that E[X] = alpha * x_m / (alpha - 1) = 1.
    Variance is finite only for alpha > 2.
    """
    if alpha <= 1.0:
        raise ValueError("Pareto needs alpha > 1 for a finite mean")
    x_m = (alpha - 1.0) / alpha
    var = (x_m**2 * alpha / ((alpha - 1.0) ** 2 * (alpha - 2.0))
           if alpha > 2.0 else None)

    def sample(gen, shape):
        u = _uniform(gen, shape).clamp_(min=_TINY)
        return x_m * u.pow(-1.0 / alpha)

    return ServiceDist(f"pareto(a={alpha:g})", sample, variance=var)


@functools.lru_cache(maxsize=None)
def weibull(shape_k: float) -> ServiceDist:
    """Unit-mean Weibull with shape ``k`` (k < 1 => heavier than exponential)."""
    if shape_k <= 0:
        raise ValueError("Weibull shape must be positive")
    # scale so that mean = lam * Gamma(1 + 1/k) = 1
    g1 = math.gamma(1.0 + 1.0 / shape_k)
    lam = 1.0 / g1
    var = lam**2 * (math.gamma(1.0 + 2.0 / shape_k) - g1**2)

    def sample(gen, shape):
        u = _uniform(gen, shape).clamp_(min=_TINY)
        return lam * (-torch.log(u)).pow(1.0 / shape_k)

    return ServiceDist(f"weibull(k={shape_k:g})", sample, variance=float(var))


@functools.lru_cache(maxsize=None)
def two_point(p: float) -> ServiceDist:
    """The paper's Fig 2(c) family: 0.5 w.p. p, (1 - 0.5 p)/(1 - p) w.p. 1-p.

    Unit mean by construction; variance -> infinity as p -> 1.
    """
    if not 0.0 <= p < 1.0:
        raise ValueError("two_point needs 0 <= p < 1")
    hi = (1.0 - 0.5 * p) / (1.0 - p)
    var = p * 0.25 + (1.0 - p) * hi**2 - 1.0

    def sample(gen, shape):
        u = _uniform(gen, shape)
        return torch.where(u < p, 0.5, hi).to(torch.float32)

    return ServiceDist(f"two_point(p={p:g})", sample, variance=float(var))


def discrete(values, probs, name: str = "discrete") -> ServiceDist:
    """Arbitrary discrete distribution, renormalized to unit mean.

    Used for the paper's Figure 3 (random distributions on {1..N}) and
    for storage-service empirical mixtures.
    """
    v = np.asarray(values, dtype=np.float64)
    p = np.asarray(probs, dtype=np.float64)
    p = p / p.sum()
    v = v / float((v * p).sum())  # unit mean
    var = float((p * v**2).sum() - 1.0)
    vals, pr = tuple(float(x) for x in v), tuple(float(x) for x in p)

    def sample(gen, shape):
        idx = _inverse_cdf(_uniform(gen, shape), pr)
        return torch.tensor(vals, dtype=torch.float32, device=gen.device)[idx]

    return ServiceDist(name, sample, variance=var)


def random_discrete(seed: int, support: int, *,
                    dirichlet_alpha: float | None = None,
                    name: str | None = None) -> ServiceDist:
    """A random unit-mean discrete distribution on {1, .., support}.

    ``dirichlet_alpha=None`` samples probabilities uniformly from the
    simplex (Dirichlet(1)); the paper additionally uses a symmetric
    Dirichlet with concentration 0.1 for a wider spread (Figure 3). The
    probabilities are a one-off parameter draw from ``seed``.
    """
    alpha = 1.0 if dirichlet_alpha is None else dirichlet_alpha
    probs = np.random.default_rng(seed).dirichlet(np.full(support, alpha))
    label = name or f"random_discrete(N={support},a={alpha:g})"
    return discrete(np.arange(1, support + 1), probs, name=label)


def mixture(components: list[ServiceDist], weights: list[float],
            name: str = "mixture", *, normalize: bool = True) -> ServiceDist:
    """Finite mixture of components (renormalized to unit mean).

    Storage-service models are mixtures of a fast memory path and a slow
    disk path. Every component is drawn at the full shape and the
    category picks one draw per element.
    """
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    wt = tuple(float(x) for x in w)
    comps = tuple(components)
    mixture_mean = float((w * [c.mean for c in comps]).sum())
    # E[X^2] of a mixture is the weighted sum of component second moments.
    var = None
    if all(c.variance is not None for c in comps):
        e2 = float((w * [c.variance + c.mean**2 for c in comps]).sum())
        var = e2 - mixture_mean**2
    div = 1.0
    if normalize and abs(mixture_mean - 1.0) > 1e-6:
        div = mixture_mean
        if var is not None:
            var = var / mixture_mean**2
        mixture_mean = 1.0

    def sample(gen, shape):
        idx = _inverse_cdf(_uniform(gen, shape), wt)
        draws = torch.stack([c.sample(gen, shape) for c in comps])
        out = torch.gather(draws, 0, idx.unsqueeze(0))[0]
        return out / div if div != 1.0 else out

    return ServiceDist(name, sample, mean=mixture_mean, variance=var)


@dataclasses.dataclass(frozen=True, repr=False)  # keep the short repr
class EmpiricalDist(ServiceDist):
    """A unit-mean quantile-table distribution fitted from samples.

    ``table`` holds the n+1 unit-mean quantile knots q_0..q_n at the
    evenly spaced probabilities u_i = i/n; sampling is inverse-CDF with
    linear interpolation between knots. ``scale`` is the mean of the
    ORIGINAL samples (e.g. milliseconds), so ``x * scale`` maps a draw
    back to sample units.
    """

    table: tuple[float, ...] = ()
    scale: float = 1.0

    def exceedance(self, x: float) -> float:
        """P[X > x] with ``x`` in ORIGINAL sample units (table geometry:
        linear interpolation of the fitted CDF)."""
        knots = np.asarray(self.table, dtype=np.float64) * self.scale
        u = np.linspace(0.0, 1.0, len(knots))
        return float(1.0 - np.interp(x, knots, u, left=0.0, right=1.0))

    @classmethod
    def from_trace(cls, path, *, n_quantiles: int = 512,
                   name: str | None = None) -> "EmpiricalDist":
        """Fit a quantile table from a latency TRACE file: newline-
        delimited samples in milliseconds (blank lines and ``#``
        comments skipped). ``scale`` holds the trace mean in ms."""
        with open(path) as fh:
            vals = [float(ln) for ln in (s.strip() for s in fh)
                    if ln and not ln.startswith("#")]
        if len(vals) < 2:
            raise ValueError(f"trace {path!r} has {len(vals)} usable "
                             f"sample(s); need at least 2")
        label = name or f"trace:{os.path.basename(str(path))}"
        return empirical(np.asarray(vals), n_quantiles=n_quantiles,
                         name=label)


def empirical(samples, *, n_quantiles: int = 512,
              name: str = "empirical") -> EmpiricalDist:
    """Fit a unit-mean quantile-table distribution to ``samples``.

    Fits n+1 quantile knots at u_i = i/n (float64; the top knot is moved
    from the sample max to the value whose uniform lerp matches the
    empirical tail-conditional mean), takes the EXACT mean of the
    piecewise-linear law (trapezoid rule over the knots) as ``scale``,
    and normalizes the knots to unit mean. The closed-form variance of
    the piecewise-linear law is
    ``sum((q_i^2 + q_i q_{i+1} + q_{i+1}^2) / (3n)) - 1``.
    """
    s = np.asarray(samples, dtype=np.float64).ravel()
    if s.size < 2:
        raise ValueError("empirical needs at least 2 samples")
    if not np.all(np.isfinite(s)):
        raise ValueError("empirical needs finite samples")
    if np.any(s < 0):
        raise ValueError("service-time samples must be non-negative")
    n = int(n_quantiles)
    if n < 2:
        raise ValueError("n_quantiles must be >= 2")
    q = np.quantile(s, np.linspace(0.0, 1.0, n + 1))
    # The raw top knot is the sample MAX; lerping the top bin uniformly
    # up to it overweights a heavy tail. Replace it so the top bin's
    # uniform lerp reproduces the tail-conditional mean:
    # (q_{n-1} + q_n) / 2 == mean(s | s >= q_{n-1}).
    tail = s[s >= q[-2]]
    if tail.size:
        q[-1] = max(q[-2], 2.0 * float(tail.mean()) - q[-2])
    scale = float((0.5 * q[0] + q[1:-1].sum() + 0.5 * q[-1]) / n)
    if scale <= 0.0:
        raise ValueError("empirical needs samples with a positive mean")
    q = q / scale
    var = float(((q[:-1] ** 2 + q[:-1] * q[1:] + q[1:] ** 2) / 3.0).mean()
                - 1.0)
    table = tuple(float(v) for v in q)

    def sample(gen, shape):
        tbl = torch.tensor(table, dtype=torch.float32, device=gen.device)
        x = _uniform(gen, shape) * n
        idx = x.to(torch.int64).clamp_(0, n - 1)
        frac = x - idx.to(torch.float32)
        lo = tbl[idx]
        return lo + (tbl[idx + 1] - lo) * frac

    return EmpiricalDist(f"{name}[q{n}]", sample, variance=var,
                         table=table, scale=scale)


@functools.lru_cache(maxsize=None)
def scaled(dist: ServiceDist, scale: float) -> ServiceDist:
    """Scale a unit-mean distribution to mean ``scale`` (storage sims use
    real milliseconds)."""

    def sample(gen, shape):
        return dist.sample(gen, shape) * scale

    var = None if dist.variance is None else dist.variance * scale**2
    return ServiceDist(f"{dist.name}*{scale:g}", sample, mean=dist.mean * scale,
                       variance=var)



# Registry used by the benchmarks and the explorer's command line.
FAMILIES = {
    "exponential": exponential,
    "deterministic": deterministic,
    "pareto": pareto,
    "weibull": weibull,
    "two_point": two_point,
}

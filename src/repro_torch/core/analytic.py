"""Closed-form results from the paper (the port's copy of
``repro.core.analytic``).

* Theorem 1 (M/M/1 + replication): with unit-mean exponential service and
  per-server arrival rate rho, mean response is 1/(1-rho) unreplicated and
  1/(2(1-2rho)) with k=2 (min of two independent Exp(1-2rho) samples), so
  replication helps iff rho < 1/3.
* The general-k M/M/1 approximation (k-way independent queues).
* Light-load means for the timed policies (``hedge_mean_light`` /
  ``retry_mean_light``).
* The §3.1 TCP handshake model (``TCPModel``, ``handshake_times``) and
  its first-order saving, with the cost benchmark of 16 ms per KB.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device, seeded_generator

THRESHOLD_EXPONENTIAL = 1.0 / 3.0
# Paper: deterministic-service threshold from queueing-model simulation.
THRESHOLD_DETERMINISTIC = 0.2582


def mm1_mean(rho):
    """Mean response of an M/M/1 queue with unit-mean service."""
    rho = np.asarray(rho, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return np.where(rho < 1.0, 1.0 / (1.0 - rho), np.inf)


def mm1_response_cdf(t, rho):
    """P(response <= t) for M/M/1: Exp(1 - rho)."""
    t, rho = np.asarray(t, np.float64), np.asarray(rho, np.float64)
    return 1.0 - np.exp(-(1.0 - rho) * t)


def mm1_replicated_mean(rho, k: int = 2):
    """Mean of min over k independent M/M/1 responses, each at load k*rho."""
    rate = 1.0 - k * np.asarray(rho, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return np.where(rate > 0.0, 1.0 / (k * rate), np.inf)


def hedge_mean_light(d):
    """Light-load mean response of ``HEDGE_AFTER_DELAY`` with a copy budget
    of 2, unit-mean exponential service and hedge delay ``d``: the primary
    finishes by ``d`` with its own draw, else the residual primary and the
    fresh hedge race from ``d`` (min of two Exp(1)):
    E[T] = 1 - e^{-d}/2."""
    return 1.0 - np.exp(-np.asarray(d, np.float64)) / 2.0


def retry_mean_light(d, f=0.0):
    """Light-load mean response of ``TIMEOUT_RETRY`` with an attempt budget
    of 2, unit-mean exponential service, deadline ``d`` and blackhole
    probability ``f`` (the last attempt is exempt):
    E[T] = (1-f) (1 - e^{-d}/2) + f (1 + d)."""
    d, f = np.asarray(d, np.float64), np.asarray(f, np.float64)
    return (1.0 - f) * (1.0 - np.exp(-d) / 2.0) + f * (1.0 + d)


def mm1_cancel_bounds(rho, k: int = 2):
    """(lower, upper) bounds on the mean response of replication WITH
    cancellation-on-complete (unit-mean exponential service): the winning
    copy's service, mean ``1/k``, below; the unreplicated M/M/1 mean
    above (redundancy never hurts memoryless service with cancellation)."""
    rho = np.asarray(rho, dtype=np.float64)
    return np.full_like(rho, 1.0 / k), mm1_mean(rho)


def exponential_threshold(k: int = 2, overhead: float = 0.0) -> float:
    """Largest rho with mm1_replicated_mean(rho,k) + overhead < mm1_mean(rho).

    For k=2, c=0 this is exactly 1/3 (Theorem 1); otherwise solved by
    bisection."""
    if k == 2 and overhead == 0.0:
        return THRESHOLD_EXPONENTIAL
    lo, hi = 1e-6, 1.0 / k - 1e-9

    def f(r):
        return float(mm1_replicated_mean(r, k) + overhead - mm1_mean(r))

    if f(lo) >= 0.0:
        return 0.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if f(mid) < 0.0:
            lo = mid
        else:
            hi = mid
    return float(np.round(0.5 * (lo + hi), 6))


# ---------------------------------------------------------------------------
# §3.1 TCP connection establishment
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TCPModel:
    rtt: float = 0.03           # seconds
    p_single: float = 0.0048    # measured single-packet loss prob [Chan et al.]
    p_pair: float = 0.0007      # measured back-to-back pair loss prob
    syn_timeout: float = 3.0    # Linux initial SYN / SYN-ACK RTO
    max_retries: int = 8


def _completion_from_uniform(u: torch.Tensor, p: float, timeout: float,
                             rtt: float, max_retries: int) -> torch.Tensor:
    """Packet completion times (float32) from uniforms ``u`` in [0, 1):
    retry r (r=0..R) succeeds w.p. (1-p) p^r, and its completion time is
    sum_{j<r} timeout*2^j + rtt/2. The geometric is inverted as
    r = floor(log(1-u)/log(p)), clipped, in float32 as the JAX package
    computes it."""
    log_p = torch.log(torch.full_like(u, p))
    r = torch.floor(torch.log1p(-u) / log_p).clamp_(0, max_retries)
    return timeout * (torch.exp2(r) - 1.0) + rtt / 2.0


def _packet_completion_time(gen: torch.Generator, p: float, timeout: float,
                            rtt: float, shape: tuple[int, ...],
                            max_retries: int) -> torch.Tensor:
    """Time until a packet is first delivered, with exponential backoff,
    on the generator's device."""
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return _completion_from_uniform(u, p, timeout, rtt, max_retries)


def handshake_times(seed: int, model: TCPModel, n: int, duplicated: bool,
                    device="cuda") -> torch.Tensor:
    """Monte-Carlo handshake completion times (n,) under the §3.1 model:
    SYN, SYN-ACK and ACK, each from its own generator of ``seed``. Equal
    seeds give the duplicated and single runs the same uniforms (CRN)."""
    dev = resolve_device(device)
    p = model.p_pair if duplicated else model.p_single
    syn, synack, ack = (
        _packet_completion_time(seeded_generator((seed, j), dev), p,
                                timeout, model.rtt, (n,), model.max_retries)
        for j, timeout in enumerate((model.syn_timeout, model.syn_timeout,
                                     3.0 * model.rtt)))
    return syn + synack + ack


def handshake_mean_saving(model: TCPModel) -> float:
    """First-order expected saving (the paper's back-of-envelope):
    (3 + 3 + 3*RTT) * (p_single - p_pair)."""
    dp = model.p_single - model.p_pair
    return (model.syn_timeout * 2 + 3.0 * model.rtt) * dp


# Cost-effectiveness benchmark from Vulimiri et al. [28, 29]:
BENEFIT_THRESHOLD_MS_PER_KB = 16.0

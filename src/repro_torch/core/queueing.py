"""Discrete-event simulation of the paper's replication queueing model (§2.1).

Model (exactly as in the paper): ``N`` independent identical FIFO servers,
Poisson arrivals at rate ``N * rho`` (so each server sees utilization ``rho``
without replication), each arriving request is copied to ``k`` distinct
servers chosen uniformly at random, every copy is served to completion
(no cancellation — this is what doubles utilization), and the request's
response time is the minimum over its copies' (queueing delay + service
time). An optional fixed ``client_overhead`` is added to every request when
k > 1 (paper Figure 4). ``repro_torch.core.scenario`` widens this to the
cancellation, dispatch-to-idle and timed policies, server-dependent service
and per-copy degradation.

This is the PyTorch port of ``repro.core.queueing``: the same cell plan,
chunk layout, carry and summaries, with the chunk body running the CUDA
``cell_update`` kernel on the card (``repro_torch.kernels.cell_update``).

Sweep engine
------------
``run`` flattens a (seed, load, variant) grid into one cell axis
(``repro_torch.core.cellplan``) and streams the arrivals in chunks. Per
chunk it samples the inputs at SEED granularity — unit-rate gaps (S, T),
copy sets (S, T, k_max), service columns — and ``_sweep_chunk_cells``
runs every cell over them; only the per-cell carry (free times relative to
the chunk start, Kahan sum, completed count, log-bin histogram) crosses
chunk boundaries, so memory is independent of ``cfg.n_arrivals``.
``_finalize_summary`` reads means and sketch percentiles.

Generator streams and the CRN contract
--------------------------------------
All randomness comes from ``torch.Generator``s seeded from the run's int
``seed``: stream ``(seed, chunk, seed_row, purpose, j)`` is a generator of
its own (``_stream``), so every draw is a pure function of those ints and
of nothing that is sampled before it. Common random numbers follow:

  * one arrival stream per (seed, chunk, seed row) — the gaps are scaled by
    each cell's rate at run time, so all loads, all service distributions
    and all systems of a grid share one arrival process and copy sets;
  * copy sets are nested across k: extras are the top-scoring offsets of
    one score matrix, sorted stably, so k=2's extra server is one of
    k=3's for any ``k_max``;
  * copy j's service draw has its own stream (``_SERVICE``, j), identical
    for every ``k_max``; the SERVER_DEPENDENT shared component has its own
    fixed stream (``_SHARED``) and is appended only when a grid needs it;
  * a dedicated degradation stream (``_DEGRADE_STREAM``, j) draws the
    per-copy failure/straggler uniforms only for degraded grids, so healthy
    cells keep their bits in a grid that also holds degraded ones;
  * chunk c of a stream does not depend on how many chunks follow, and
    ``pipeline="on"`` / ``"off"`` give the same bits (sampling moves in
    time, never in content).

Torch's generators do not reproduce JAX's threefry draws: the port is
held to the JAX package bit for bit at the kernel boundary (injected
inputs) and statistically for whole runs (closed forms, and identical
draws replayed through both engines with ``repro_torch.interop``).
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from repro_torch.core import cellplan
from repro_torch.core import chunkflow
from repro_torch.core import scenario as scenario_mod
from repro_torch.core.distributions import ServiceDist
from repro_torch.core.scenario import Scenario, Variant
from repro_torch.device import resolve_device, seeded_generator
from repro_torch.kernels import dispatch
from repro_torch.kernels.cell_update import ops as cell_ops
from repro_torch.kernels.cell_update import ref as cell_ref
from repro_torch.kernels.hist_sketch import ops as hist_ops
from repro_torch.kernels.hist_sketch.ops import (DEFAULT_BINS,  # noqa: F401
                                                 HIST_HI, HIST_LO)

DEFAULT_PERCENTILES = (50.0, 90.0, 99.0, 99.9)

# Steps staged per plain-path histogram fold; chunk lengths are padded
# up to a multiple of this with zero-weight no-op arrivals when the
# sketch is on.
_SKETCH_BLOCK = 512

# Why ``run(mesh=)``, sweep_engine's sharded part and the explorer's
# ``--devices`` raise: the one message all three give.
MESH_NOT_PORTED = (
    "a sharded 'cells' mesh runs the sharded executor, which belongs to the "
    "port's multi-device slice (repro.distributed.sweep_shard; ROADMAP "
    "queue 1 item 13) and is not ported yet")

# Purposes of the generator streams (see the module note).
_GAPS, _FIRST, _SCORES, _SERVICE, _SHARED, _DEGRADE_STREAM = range(6)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Machine shape of a simulation. ``warmup_frac``/``client_overhead``
    are the knobs the paper-default estimators read; ``run`` reads them
    from the ``Scenario`` instead."""

    n_servers: int = 20
    n_arrivals: int = 100_000
    warmup_frac: float = 0.1
    client_overhead: float = 0.0  # latency penalty added to replicated requests


def _overhead_when_replicated(overhead: float, k: int) -> float:
    """The paper's Figure 4 rule: client overhead is charged only when a
    request is replicated (k > 1)."""
    return float(overhead) if k > 1 else 0.0


def _stream(seed: int, chunk: int, row: int, purpose: int, j: int,
            device: torch.device) -> torch.Generator:
    """The generator of stream ``(seed, chunk, row, purpose, j)``."""
    return seeded_generator((seed, chunk, row, purpose, j), device)


def _arrival_part(seed: int, chunk: int, row: int, n: int, m: int,
                  k_max: int, device: torch.device):
    """Distribution-independent randomness of one seed row: unit-rate
    exponential gaps (m,) (scaled by each cell's rate at run time, so one
    stream couples every load) and the copy sets (m, k_max) int32 — a
    uniform first server plus ``k_max - 1`` distinct extras, the
    top-scoring offsets of one (m, n-1) score matrix (nested across k)."""
    gaps = torch.empty(m, device=device, dtype=torch.float32).exponential_(
        generator=_stream(seed, chunk, row, _GAPS, 0, device))
    first = torch.randint(0, n, (m,), device=device,
                          generator=_stream(seed, chunk, row, _FIRST, 0,
                                            device))
    if k_max > 1:
        scores = torch.rand((m, n - 1), device=device,
                            generator=_stream(seed, chunk, row, _SCORES, 0,
                                              device))
        offs = torch.sort(scores, dim=1, descending=True,
                          stable=True).indices[:, :k_max - 1]
        servers = torch.cat([first[:, None], (first[:, None] + 1 + offs) % n],
                            dim=1)
    else:
        servers = first[:, None]
    return gaps, servers.to(torch.int32)


def _service_part(seed: int, chunk: int, row: int, dist: ServiceDist, m: int,
                  n_copies: int, with_shared: bool, with_degr: bool,
                  device: torch.device):
    """(m, n_svc) service columns of one seed row, laid out
    ``[copies][shared?][degradation?]``: copy j from stream (_SERVICE, j),
    the SERVER_DEPENDENT shared component from the fixed _SHARED stream,
    and ``n_copies`` degradation uniforms from the dedicated
    _DEGRADE_STREAM. Consumers receive ``with_shared`` separately (the
    column count alone is ambiguous at ``n_copies == 1``)."""
    cols = [dist.sample(_stream(seed, chunk, row, _SERVICE, j, device), (m,))
            for j in range(n_copies)]
    if with_shared:
        cols.append(dist.sample(_stream(seed, chunk, row, _SHARED, 0, device),
                                (m,)))
    if with_degr:
        cols.extend(torch.rand((m,), device=device, generator=_stream(
            seed, chunk, row, _DEGRADE_STREAM, j, device))
            for j in range(n_copies))
    return torch.stack(cols, dim=1)


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Static descriptor of a sweep's per-chunk randomness.

    ``kind`` picks the input-block layout:

      ``"single"``   one distribution; gaps/servers/services all have
                     ``n_seeds`` rows.
      ``"stacked"``  multi-dist scenarios: every dist shares the arrival
                     process (CRN), so gaps / servers are sampled once and
                     TILED ``d`` times; seed-row and service-row spaces
                     both have ``d * n_seeds`` rows.
      ``"tables"``   heterogeneous per-cell ``dist_id`` grids: gaps /
                     servers keep ``n_seeds`` rows, services stack one
                     table per dist-union member (``d * n_seeds`` service
                     rows reached via ``svc_idx``).
    """

    kind: str
    dists: tuple[ServiceDist, ...]
    cfg: SimConfig
    k_max: int
    n_seeds: int
    with_shared: bool = False
    with_degr: bool = False

    @property
    def n_dists(self) -> int:
        return len(self.dists)

    @property
    def n_seed_rows(self) -> int:
        """Rows of the gaps/servers block (the seed-row space)."""
        return self.n_seeds * (self.n_dists if self.kind == "stacked"
                               else 1)

    @property
    def n_svc_rows(self) -> int:
        """Rows of the services block (the service-row space)."""
        return self.n_seeds * (self.n_dists if self.kind != "single"
                               else 1)

    @property
    def n_svc_cols(self) -> int:
        return (self.k_max + int(self.with_shared)
                + self.k_max * int(self.with_degr))


class ChunkSampler:
    """The engine's per-chunk input sampler: ``sampler(c, t)`` returns
    chunk ``c``'s ``(unit_gaps (S,T), servers (S,T,k_max) int32, services
    (S_svc,T,n_svc))`` on ``device``. Service row ``r`` of a multi-dist
    block is dist ``r // n_seeds`` drawn from seed row ``r % n_seeds``'s
    streams — the same streams for every dist (CRN across dists)."""

    def __init__(self, spec: SamplerSpec, seed: int, device="cuda"):
        self.spec = spec
        self.seed = int(seed)
        self.device = resolve_device(device)

    def __call__(self, c: int, t: int):
        sp, dev = self.spec, self.device
        arr = [_arrival_part(self.seed, c, s, sp.cfg.n_servers, t,
                             sp.k_max, dev) for s in range(sp.n_seeds)]
        gaps = torch.stack([a[0] for a in arr])
        servers = torch.stack([a[1] for a in arr])
        services = torch.stack(
            [_service_part(self.seed, c, s, dist, t, sp.k_max,
                           sp.with_shared, sp.with_degr, dev)
             for dist in sp.dists for s in range(sp.n_seeds)])
        if sp.kind == "stacked":
            d = sp.n_dists
            gaps, servers = gaps.repeat(d, 1), servers.repeat(d, 1, 1)
        return gaps, servers, services


def make_sampler(seed: int, dist_list, cfg: SimConfig, k_max: int,
                 n_seeds: int, *, has_dists: bool = False,
                 with_shared: bool = False, with_degr: bool = False,
                 device="cuda") -> ChunkSampler:
    """The sampler behind ``run``: ``"single"`` for one dist, ``"tables"``
    for a heterogeneous grid, ``"stacked"`` otherwise. ``device`` is
    resolved as ``run`` resolves it (CUDA unless the CPU is asked for)."""
    dist_list = tuple(dist_list)
    kind = ("single" if len(dist_list) == 1
            else "tables" if has_dists else "stacked")
    return ChunkSampler(SamplerSpec(kind, dist_list, cfg, k_max, n_seeds,
                                    with_shared, with_degr), seed, device)


# ---------------------------------------------------------------------------
# Raw per-arrival responses (one variant)
# ---------------------------------------------------------------------------

def _sample_inputs(seed: int, dist: ServiceDist, cfg: SimConfig, k_max: int,
                   with_shared: bool = False, with_degr: bool = False, *,
                   row: int = 0, device):
    """All randomness of one stream up front: unit gaps (M,), copy sets
    (M, k_max) and service columns (M, n_svc), from the streams of seed
    row ``row`` of an unchunked ``run`` (the same draws, so copy 0 is
    shared by every k)."""
    gaps, servers = _arrival_part(seed, 0, row, cfg.n_servers,
                                  cfg.n_arrivals, k_max, device)
    services = _service_part(seed, 0, row, dist, cfg.n_arrivals, k_max,
                             with_shared, with_degr, device)
    return gaps, servers, services


def _scan_sim(arrivals: torch.Tensor, servers: torch.Tensor,
              services: torch.Tensor, n_servers: int,
              variant: Variant) -> torch.Tensor:
    """Run the FIFO replication DES for ONE scenario variant: arrivals
    (M,) — or (B, M), B loads stepped together over the same copy sets
    and service draws — servers (M, k), services (M, k) or with the
    shared component and the degradation uniforms after the copies ->
    response times of the arrivals' shape.

    Each arrival is one call of ``cell_update.ref.step_cell``, the
    physics of the engine and of the ``cell_update`` kernel. This is the
    plain path by design: the kernel folds responses into sums and a
    sketch, and raw per-arrival responses are what this returns. On the
    card it is paced by the host, one arrival at a time."""
    t_all = arrivals.reshape(-1, arrivals.shape[-1])             # (C, M)
    c, m = t_all.shape
    dev = t_all.device
    k = servers.shape[1]
    n_base = k + (1 if variant.needs_shared_draw else 0)

    def f32(x):
        return torch.tensor(float(x), dtype=torch.float32, device=dev)

    shared = services[:, k if variant.needs_shared_draw else 0, None]
    degr = (services[:, n_base:n_base + k] if variant.needs_degradation_draw
            else torch.zeros_like(services[:, :k]))
    svc, alive = cell_ref.service_times(
        services[:, :k], shared, degr,
        torch.tensor(int(variant.service_model), device=dev),
        f32(variant.mix), f32(variant.p_slow), f32(variant.slow_factor),
        f32(variant.p_fail))                                     # (M, k)
    policy = torch.full((c,), int(variant.policy), dtype=torch.int32,
                        device=dev)
    mask = torch.ones((c, k), dtype=torch.bool, device=dev)
    ovh = f32(_overhead_when_replicated(variant.overhead, k)).expand(c)
    srv_all = servers.to(torch.int64)
    timed = {}
    if variant.policy in scenario_mod.TIMED_POLICIES:
        is_retry = variant.policy == scenario_mod.Policy.TIMEOUT_RETRY
        coeff = torch.tensor(cell_ref.retry_offsets(k) if is_retry
                             else [float(j) for j in range(k)],
                             dtype=torch.float32, device=dev)
        delay = f32(variant.delay)
        alive_eff = alive.clone()
        if is_retry:  # the last attempt in budget ignores its blackhole
            alive_eff[:, k - 1] = True
        timed = dict(disp_t=t_all[:, :, None] + delay * coeff,  # (C, M, k)
                     alive_eff=alive_eff, fire_all=(delay <= 0.0).expand(c))
    free = torch.zeros((c, n_servers), dtype=torch.float32, device=dev)
    resp = torch.empty((c, m), dtype=torch.float32, device=dev)
    arms = {int(variant.policy)}
    for s in range(m):
        kw = {}
        if timed:
            kw = dict(disp_t=timed["disp_t"][:, s],
                      alive_eff=timed["alive_eff"][s].expand(c, k),
                      fire_all=timed["fire_all"])
        resp[:, s] = cell_ref.step_cell(
            free, t_all[:, s], srv_all[s].expand(c, k),
            svc[s].expand(c, k), alive[s].expand(c, k), mask, ovh, policy,
            arms=arms, **kw)
    return resp.reshape(arrivals.shape)


def _default_scenario(dist: ServiceDist, cfg: SimConfig,
                      scenario: Scenario | None) -> Scenario:
    return scenario or Scenario.paper_default(
        dist, client_overhead=cfg.client_overhead,
        warmup_frac=cfg.warmup_frac)


def simulate(seed: int, dist: ServiceDist, rho, cfg: SimConfig, k: int = 1,
             *, scenario: Scenario | None = None, row: int = 0,
             device="cuda") -> torch.Tensor:
    """Response times (M,) for a single load ``rho`` and replication
    ``k``, through ``_scan_sim`` (host-paced on the card).

    Routed through the paper-default ``Scenario`` by default;
    ``scenario`` overrides policy / service model / mix / overhead for
    raw-response studies of the wider policy space (its ``dists``/``ks``
    are ignored here — ``dist``/``k`` stay authoritative). ``(seed,
    row)`` names the streams: those of seed row ``row`` of an unchunked
    ``run(seed, ...)``, the port's counterpart of a split JAX key."""
    dev = resolve_device(device)
    variant = _default_scenario(dist, cfg, scenario).variant_for(k)
    unit_gaps, servers, services = _sample_inputs(
        seed, dist, cfg, k, variant.needs_shared_draw,
        variant.needs_degradation_draw, row=row, device=dev)
    rate = cfg.n_servers * torch.as_tensor(rho, dtype=torch.float32,
                                           device=dev)
    arrivals = _row_cumsum((unit_gaps / rate)[None])[0]
    return _scan_sim(arrivals, servers[:, :k], services, cfg.n_servers,
                     variant)


def simulate_grid(seed: int, dist: ServiceDist, rhos, cfg: SimConfig,
                  k: int = 1, *, scenario: Scenario | None = None,
                  row: int = 0, device="cuda") -> torch.Tensor:
    """Response times (B, M) for a grid of loads, one coupled sample path
    (every load steps through the same draws, all B at once).
    ``scenario``, ``row`` as in ``simulate``."""
    dev = resolve_device(device)
    variant = _default_scenario(dist, cfg, scenario).variant_for(k)
    unit_gaps, servers, services = _sample_inputs(
        seed, dist, cfg, k, variant.needs_shared_draw,
        variant.needs_degradation_draw, row=row, device=dev)
    rates = cfg.n_servers * torch.as_tensor(rhos, dtype=torch.float32,
                                            device=dev)            # (B,)
    arrivals = _row_cumsum(unit_gaps[None]) / rates[:, None]        # (B, M)
    return _scan_sim(arrivals, servers[:, :k], services, cfg.n_servers,
                     variant)


def _warm(resp: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    return resp[..., int(cfg.n_arrivals * cfg.warmup_frac):]


def summarize(resp: torch.Tensor, cfg: SimConfig,
              percentiles=DEFAULT_PERCENTILES) -> dict[str, torch.Tensor]:
    """Post-warmup mean + percentiles (linear interpolation) along the
    last axis of raw response times."""
    r = _warm(resp, cfg)
    out = {"mean": r.mean(dim=-1)}
    for p in percentiles:
        out[f"p{p:g}"] = torch.quantile(r, p / 100.0, dim=-1)
    return out


# ---------------------------------------------------------------------------
# Sweep engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineGrid:
    """A run's cell plan with its per-cell parameters (C,) each
    (``_plan_cell_params``) and the grid's flags. Everything the kernel
    reads is built here once per run, in the dtype it reads, so a chunk's
    launch casts nothing and reads nothing back from the device."""

    plan: cellplan.CellPlan
    seed_idx: torch.Tensor      # (C,) int32 seed row per cell
    rates: torch.Tensor
    k_mask: torch.Tensor        # (C, k_max) prefix copy masks
    k_count: torch.Tensor       # (C,) int32 copies per request (mask length)
    ovh: torch.Tensor
    mix: torch.Tensor
    p_slow: torch.Tensor
    slow_factor: torch.Tensor
    p_fail: torch.Tensor
    delay: torch.Tensor
    svc_idx: torch.Tensor | None  # int32 dist_id * n_seeds + seed_idx
    has_shared: bool
    has_timed: bool
    has_dists: bool

    def cell_args(self) -> tuple:
        """The per-cell arguments of ``cell_ops.cell_update``, in order."""
        p = self.plan
        return (self.seed_idx, self.rates, self.k_mask, self.ovh,
                p.policy_code, p.model_code, self.mix, self.p_slow,
                self.slow_factor, self.p_fail, self.delay, self.svc_idx)

    def flags(self) -> dict:
        """The keyword arguments of ``cell_ops.cell_update``: the grid's
        flags and the copy counts of ``k_mask``."""
        return dict(has_shared=self.has_shared, has_timed=self.has_timed,
                    has_dists=self.has_dists, k_count=self.k_count)


def _plan_cell_params(plan: cellplan.CellPlan, rhos: torch.Tensor,
                      cfg: SimConfig, variants: tuple[Variant, ...]) -> dict:
    """Per-cell engine parameters gathered from the plan's coordinates:
    arrival rates (C,), copy masks (C,k_max) — prefixes by construction —
    and their int32 copy counts, client overheads, mixes, degradation
    probabilities / straggler factors / blackhole probabilities and
    policy delays (C,) each."""
    dev = plan.seed_idx.device
    k_max = max(v.k for v in variants)

    def per_variant(vals, dtype=torch.float32):
        return torch.tensor(vals, dtype=dtype, device=dev)[plan.k_idx]

    k_mask = torch.tensor([[j < v.k for j in range(k_max)] for v in variants],
                          device=dev)
    return dict(
        rates=(cfg.n_servers * rhos)[plan.load_idx], k_mask=k_mask[plan.k_idx],
        k_count=per_variant([v.k for v in variants], torch.int32),
        ovh=per_variant([_overhead_when_replicated(v.overhead, v.k)
                         for v in variants]),
        mix=per_variant([v.mix for v in variants]),
        p_slow=per_variant([v.p_slow for v in variants]),
        slow_factor=per_variant([v.slow_factor for v in variants]),
        p_fail=per_variant([v.p_fail for v in variants]),
        delay=per_variant([v.delay for v in variants]))


def _engine_grid(n_seeds_total: int, rhos, cfg: SimConfig, variants,
                 device) -> EngineGrid:
    """Plan the (seed, load, variant) grid on ``device`` and gather its
    per-cell parameters. ``variants`` may be plain ``ks`` ints (paper
    default, overhead from ``cfg``) or ``Variant``s."""
    dev = torch.device(device)
    variants = tuple(
        v if isinstance(v, Variant)
        else Variant(k=int(v), overhead=cfg.client_overhead)
        for v in variants)
    rhos = torch.as_tensor(rhos, dtype=torch.float32, device=dev)
    policies, models = scenario_mod.variant_codes(variants)
    plan = cellplan.make_cell_plan(
        n_seeds_total, rhos.shape[0], len(variants), policies=policies,
        models=models, dist_ids=scenario_mod.variant_dist_ids(variants),
        device=dev)
    has_dists = scenario_mod.any_dist_ids(variants)
    return EngineGrid(
        plan=plan, seed_idx=plan.seed_idx.to(torch.int32),
        **_plan_cell_params(plan, rhos, cfg, variants),
        svc_idx=((plan.dist_id * n_seeds_total + plan.seed_idx).to(
            torch.int32) if has_dists else None),
        has_shared=scenario_mod.any_server_dependent(variants),
        has_timed=scenario_mod.any_timed(variants), has_dists=has_dists)


def _chunk_inputs(unit_gaps, services, start: int, n_valid: int,
                  warmup_start: int):
    """A sampled chunk as the cell update reads it: ``(cum (S,T), warm
    (T,), valid (T,), services)``. Steps at or past ``n_valid`` are
    padding — zero gap, zero service, zero weight — and ``cum`` holds the
    arrival offsets from the chunk start."""
    T = unit_gaps.shape[1]
    i = torch.arange(T, device=unit_gaps.device)
    valid = i < n_valid
    warm = (valid & (start + i >= warmup_start)).to(torch.float32)
    valid_f = valid.to(torch.float32)
    return (_row_cumsum(unit_gaps * valid_f), warm, valid_f,
            services * valid_f[None, :, None])


def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, dim=1)`` of an (S, T) tensor, the same bits in
    every run. On CUDA a single row (S = 1) would take PyTorch's
    device-wide scan, whose float32 order varies from run to run; two
    copies of the row take the per-row scan, whose order is fixed."""
    if x.is_cuda and x.shape[0] == 1:
        return torch.cumsum(x.expand(2, -1), dim=1)[:1]
    return torch.cumsum(x, dim=1)


def _sweep_chunk_cells(free, ssum, comp, cnt, hist, unit_gaps, servers,
                       services, start: int, n_valid: int,
                       warmup_start: int, grid: EngineGrid, *, n_bins: int,
                       block: int, kernel: str = "auto"):
    """Scenario- and distribution-agnostic core over ONE chunk of
    arrivals, on the flat cell axis.

    Per-cell carry: ``free`` (C,N) server-free times RELATIVE to the chunk
    start, ``ssum``/``comp`` (C,) Kahan state, ``cnt`` (C,) completed
    post-warmup responses, ``hist`` (C, n_bins) sketch counts (shape (0, 0)
    skips the sketch). Inputs stay at SEED granularity — ``unit_gaps``
    (S,T), ``servers`` (S,T,k_max), ``services`` (S or D*S,T,n_svc) — and
    the plan's ``seed_idx`` (C,) (``svc_idx`` for services in a
    heterogeneous grid) maps each cell to its rows. Returns the carry
    with ``free`` rebased to the chunk-end arrival time, so floats stay
    O(chunk duration). ``kernel`` is the mode of ``cell_ops.cell_update``.
    """
    cum, warm, valid, services = _chunk_inputs(unit_gaps, services, start,
                                               n_valid, warmup_start)
    free, ssum, comp, cnt, hist = cell_ops.cell_update(
        free, ssum, comp, cnt, hist, cum, warm, valid, servers, services,
        *grid.cell_args(), n_bins=n_bins, block=block, kernel=kernel,
        **grid.flags())
    free = free - (cum[:, -1][grid.plan.seed_idx] / grid.rates)[:, None]
    return free, ssum, comp, cnt, hist


def _init_cell_state(plan: cellplan.CellPlan, cfg: SimConfig, n_bins: int,
                     need_hist: bool):
    """Zeroed per-cell carry: free times, Kahan state, completed-response
    counts, sketch counts."""
    dev = plan.seed_idx.device
    free = torch.zeros((plan.n_padded, cfg.n_servers), device=dev)
    ssum, comp, cnt = (torch.zeros(plan.n_padded, device=dev)
                       for _ in range(3))
    hist = torch.zeros((plan.n_padded, n_bins) if need_hist else (0, 0),
                       device=dev)
    return free, ssum, comp, cnt, hist


def _chunk_layout(cfg: SimConfig, chunk_size: int | None, need_hist: bool):
    """(chunk length, #chunks, sketch block, pad-to-block) of a stream.
    Chunks are padded to a block multiple when the sketch is on (the
    plain version folds the histogram per block). Padding never changes
    bits: zero-weight steps are no-ops on the whole carry."""
    m = cfg.n_arrivals
    t_chunk = m if chunk_size is None else min(int(chunk_size), m)
    n_chunks = math.ceil(m / t_chunk)
    block = min(_SKETCH_BLOCK, t_chunk)
    pad = (-t_chunk) % block if need_hist else 0
    return t_chunk, n_chunks, block, pad


def _pad_chunk_inputs(unit_gaps, servers, services, pad: int):
    """Zero-pad a chunk's sampled inputs up to the sketch-block multiple."""
    if pad:
        unit_gaps = torch.nn.functional.pad(unit_gaps, (0, pad))
        servers = torch.nn.functional.pad(servers, (0, 0, 0, pad))
        services = torch.nn.functional.pad(services, (0, 0, 0, pad))
    return unit_gaps, servers, services


def _finalize_summary(plan: cellplan.CellPlan, ssum, cnt, hist, count: int,
                      percentiles: tuple[float, ...]) -> dict:
    """Per-cell streaming state -> stacked (S,B,K) summaries. ``count`` is
    the post-warmup OFFERED count; ``cnt`` the per-cell COMPLETED count
    (less when a degraded cell blackholes every copy of a request); the
    mean divides by ``cnt``."""
    completed = cellplan.unflatten(plan, cnt)
    out = {"mean": cellplan.unflatten(plan, ssum) / completed,
           "count": count, "completed": completed}
    if percentiles:
        quant = hist_ops.sketch_quantiles(cellplan.unflatten(plan, hist),
                                          percentiles)          # (Q,S,B,K)
        for qi, p in enumerate(percentiles):
            out[f"p{p:g}"] = quant[qi]
    return out


def _run_engine(sampler, n_seeds_total: int, rhos, cfg: SimConfig, *,
                variants: tuple[Variant, ...], warmup_frac: float,
                percentiles: tuple[float, ...], n_bins: int,
                chunk_size: int | None, kernel: str = "auto",
                pipeline: str = "off", device) -> dict:
    """Drive ``_sweep_chunk_cells`` over the whole arrival stream: plan,
    per-cell parameters, zeroed carry, one body call per chunk,
    summaries. ``sampler(c, t)`` returns chunk ``c``'s inputs (see
    ``ChunkSampler``; ``repro_torch.interop.NumpySampler`` replays
    pre-drawn chunks). ``pipeline`` is ``"on"`` or ``"off"``: ``"on"``
    draws chunk ``c+1`` on a producer thread while chunk ``c`` runs.
    ``device`` is a resolved ``torch.device`` (``run`` resolves it)."""
    m = cfg.n_arrivals
    grid = _engine_grid(n_seeds_total, rhos, cfg, variants, device)
    plan = grid.plan
    warmup_start = int(m * warmup_frac)
    need_hist = len(percentiles) > 0
    t_chunk, n_chunks, block, pad = _chunk_layout(cfg, chunk_size, need_hist)
    free, ssum, comp, cnt, hist = _init_cell_state(plan, cfg, n_bins,
                                                   need_hist)
    use_pipe = pipeline == "on" and n_chunks > 1

    def produce(c: int):
        return _pad_chunk_inputs(*sampler(c, t_chunk), pad)

    for c, (unit_gaps, servers, services) in enumerate(
            chunkflow.iter_staged(produce, n_chunks, enabled=use_pipe)):
        start = c * t_chunk
        free, ssum, comp, cnt, hist = _sweep_chunk_cells(
            free, ssum, comp, cnt, hist, unit_gaps, servers, services,
            start, min(t_chunk, m - start), warmup_start, grid,
            n_bins=n_bins, block=block, kernel=kernel)
    return _finalize_summary(plan, ssum, cnt, hist, m - warmup_start,
                             percentiles)


def run(seed: int, scenario: scenario_mod.ScenarioLike, rhos,
        cfg: SimConfig, *, n_seeds: int = 2,
        percentiles: tuple[float, ...] = DEFAULT_PERCENTILES,
        n_bins: int = DEFAULT_BINS, chunk_size: int | None = None,
        kernel: str = "auto", pipeline: str = "off", mesh=None,
        device="cuda") -> dict:
    """Execute a ``Scenario`` (or a sequence — a MIXED grid) over a load
    grid. THE public entry point of the sweep engine.

    Returns post-warmup summaries as tensors on ``device``, each of shape
    ``(n_seeds, len(rhos), n_variants)`` — for a single scenario the
    variant axis is its ``ks`` in order; a sequence concatenates each
    scenario's variants. Scenarios with multiple ``dists`` add a leading
    dist axis. A HETEROGENEOUS sequence (scenarios with DIFFERENT single
    dists) keeps ``(n_seeds, B, n_variants)``: each variant carries its
    ``dist_id`` and its cells read their system's service table.

      ``mean``          streaming mean response
      ``p<q>``          histogram-sketch percentile per entry of
                        ``percentiles`` (``()`` skips the sketch)
      ``count``         post-warmup arrivals per cell (int)
      ``completed``     per-cell count of post-warmup requests that
                        completed (less than ``count`` only where a
                        degraded cell blackholed every copy)

    ``chunk_size=None`` samples the whole stream as one chunk; an int
    streams chunks of that many arrivals. ``kernel`` is ``"auto"`` (the
    CUDA kernels on the card, the plain version on the CPU), ``"on"`` or
    ``"off"`` (see ``repro_torch.kernels.dispatch``). ``pipeline="on"``
    samples chunk c+1 on a producer thread while chunk c is dispatched;
    the default ``"off"`` loop already samples chunk c+1 while chunk c's
    kernel runs, since launches do not wait for the card, and measured
    faster than the thread on the H100 (PERF.md). ``device``
    defaults to ``"cuda"`` and raises where there is no CUDA; pass
    ``"cpu"`` for the plain path. ``mesh`` belongs to the multi-device
    slice of the port and raises ``NotImplementedError``.

    ``warmup_frac`` and ``client_overhead`` come from the Scenario, not
    from ``cfg``.
    """
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    dev = resolve_device(device)
    dispatch.check_mode(kernel)
    dist_list, warmup_frac, variants = scenario_mod.combine(scenario)
    if pipeline not in ("on", "off"):
        raise ValueError(f"pipeline must be 'on' or 'off', got {pipeline!r}")
    k_max = max(v.k for v in variants)
    has_dists = scenario_mod.any_dist_ids(variants)
    sampler = make_sampler(
        seed, dist_list, cfg, k_max, n_seeds, has_dists=has_dists,
        with_shared=scenario_mod.any_server_dependent(variants),
        with_degr=scenario_mod.any_degraded(variants), device=dev)
    d = len(dist_list)
    out = _run_engine(sampler, n_seeds if has_dists else d * n_seeds, rhos,
                      cfg, variants=variants, warmup_frac=warmup_frac,
                      percentiles=tuple(percentiles), n_bins=n_bins,
                      chunk_size=chunk_size, kernel=kernel,
                      pipeline=pipeline, device=dev)
    if d > 1 and not has_dists:
        out = {k: (v.reshape((d, n_seeds) + tuple(v.shape[1:]))
                   if isinstance(v, torch.Tensor) else v)
               for k, v in out.items()}
    return out


def _warn_deprecated_shim(name: str) -> None:
    warnings.warn(
        f"queueing.{name} is a deprecated paper-default shim; use "
        f"queueing.run with a Scenario (bit-identical output)",
        DeprecationWarning, stacklevel=3)


def _paper_default(dist_or_dists, ks, cfg: SimConfig) -> Scenario:
    return Scenario.paper_default(dist_or_dists, ks=tuple(int(k) for k in ks),
                                  client_overhead=cfg.client_overhead,
                                  warmup_frac=cfg.warmup_frac)


def sweep(seed: int, dist: ServiceDist, rhos, cfg: SimConfig, *,
          ks: tuple[int, ...] = (1, 2), n_seeds: int = 2,
          percentiles: tuple[float, ...] = DEFAULT_PERCENTILES,
          n_bins: int = DEFAULT_BINS, chunk_size: int | None = None,
          kernel: str = "auto", device="cuda") -> dict:
    """Fused multi-(k, seed, load) sweep of the PAPER's model.

    .. deprecated:: Thin shim over ``run(seed, Scenario.paper_default(
       dist, ks=ks, ...), rhos, cfg, ...)`` — bit-identical output
       (emits ``DeprecationWarning``); prefer ``run``.

    Summary shapes, chunking and the CRN contract are exactly ``run``'s
    (single-dist layout): ``(n_seeds, len(rhos), len(ks))``.
    """
    _warn_deprecated_shim("sweep")
    return run(seed, _paper_default(dist, ks, cfg), rhos, cfg,
               n_seeds=n_seeds, percentiles=percentiles, n_bins=n_bins,
               chunk_size=chunk_size, kernel=kernel, device=device)


def sweep_dists(seed: int, dist_list, rhos, cfg: SimConfig, *,
                ks: tuple[int, ...] = (1, 2), n_seeds: int = 2,
                percentiles: tuple[float, ...] = DEFAULT_PERCENTILES,
                n_bins: int = DEFAULT_BINS, chunk_size: int | None = None,
                kernel: str = "auto", device="cuda") -> dict:
    """Sweep MANY service-time distributions in one engine call by stacking
    them along the seed axis; summaries gain a leading dist axis
    ``(len(dist_list), n_seeds, len(rhos), len(ks))``.

    .. deprecated:: Thin shim over ``run`` with a multi-``dists``
       ``Scenario.paper_default`` — bit-identical output (emits
       ``DeprecationWarning``); prefer ``run``.
    """
    _warn_deprecated_shim("sweep_dists")
    dist_list = tuple(dist_list)
    out = run(seed, _paper_default(dist_list, ks, cfg), rhos, cfg,
              n_seeds=n_seeds, percentiles=percentiles, n_bins=n_bins,
              chunk_size=chunk_size, kernel=kernel, device=device)
    if len(dist_list) == 1:  # run() adds the dist axis only for d > 1
        out = {k: (v[None] if isinstance(v, torch.Tensor) else v)
               for k, v in out.items()}
    return out


def mean_response(seed: int, dist: ServiceDist, rhos, cfg: SimConfig,
                  k: int, n_seeds: int = 1, chunk_size: int | None = None,
                  kernel: str = "auto", device="cuda") -> torch.Tensor:
    """Post-warmup mean response (B,) averaged over ``n_seeds`` seeds."""
    out = run(seed, _paper_default(dist, (k,), cfg), rhos, cfg,
              n_seeds=n_seeds, percentiles=(), chunk_size=chunk_size,
              kernel=kernel, device=device)
    return out["mean"][:, :, 0].mean(dim=0)


def replication_gain(seed: int, dist: ServiceDist, rhos, cfg: SimConfig,
                     k: int = 2, n_seeds: int = 2,
                     chunk_size: int | None = None, kernel: str = "auto",
                     device="cuda") -> torch.Tensor:
    """mean_k1(rho) - mean_k(rho), CRN-paired per seed. Positive = k helps.

    .. deprecated:: Thin shim over ``run`` with a paper-default
       ``Scenario`` at ``ks=(1, k)`` (emits ``DeprecationWarning``);
       prefer ``run`` + a paired-gain reduction (or
       ``threshold.scenario_gain``). Takes no ``mesh``: the sharded
       executor is not ported."""
    _warn_deprecated_shim("replication_gain")
    out = run(seed, _paper_default(dist, (1, k), cfg), rhos, cfg,
              n_seeds=n_seeds, percentiles=(), chunk_size=chunk_size,
              kernel=kernel, device=device)
    m = out["mean"]  # (S, B, 2)
    return (m[:, :, 0] - m[:, :, 1]).mean(dim=0)

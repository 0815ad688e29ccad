"""Declarative scenario spec for the sweep engine.

The paper's queueing model (§2.1) is ONE point in a larger policy space:
every copy is served to completion (no cancellation), copies always go
out (replicate-all), and copies' service times are i.i.d. draws. The
most-cited follow-ups sweep the rest of that space — Shah et al. ("When
Do Redundant Requests Reduce Latency?") show the answer flips once
service times carry a server-independent *request* component, and
Joshi et al. study replicate-vs-queue tradeoffs with cancellation. A
``Scenario`` names a point (or, as a sequence, a *grid*) in that space
declaratively, and ``repro_torch.core.queueing.run`` executes it on the
chunked cell-plan engine. This module is the PyTorch port's own copy of
``repro.core.scenario``: the integer codes of ``Policy`` and
``ServiceModel`` are the same, so plan coordinates can be swapped
between the two packages.

Replication policies (``Policy``):

  * ``REPLICATE_ALL`` — the paper's model: every copy is dispatched and
    served to completion; the loser copies keep occupying their servers
    after the winner finishes (this is what doubles utilization).
  * ``CANCEL_ON_COMPLETE`` — the Joshi et al. regime: when the winning
    copy finishes at ``t_win``, every loser vacates its queue slot — a
    loser already in service frees its server at ``t_win``, a loser
    still queued (its server busy past ``t_win``) is dequeued and
    consumes no server time at all.
  * ``REPLICATE_TO_IDLE`` — opportunistic replication: the primary copy
    always dispatches; extra copies dispatch only to servers that are
    idle at the arrival instant, and dispatched copies run to
    completion.
  * ``TIMEOUT_RETRY`` — the NON-redundant robustness baseline: one copy
    at a time, resent after a deadline ``delay`` with exponential
    backoff (attempt ``j`` dispatches ``delay * sum_{i<j} min(2^i,
    BACKOFF_CAP)`` after the arrival, cap 8x — see
    ``repro_torch.kernels.cell_update.ref``). ``ks`` bounds the number of
    ATTEMPTS; the final attempt is exempt from blackhole loss (it
    models the out-of-band escalation every real retry layer has), so
    retried requests always complete.
  * ``HEDGE_AFTER_DELAY`` — Joshi-style deferred hedging: the primary
    dispatches at the arrival; duplicate ``j`` dispatches at
    ``t + j * delay`` ONLY if nothing has completed by then.
    ``delay=0`` degenerates BIT-IDENTICALLY to ``REPLICATE_ALL`` (all
    copies fire at ``t``; the engine special-cases ``delay <= 0`` so
    the dispatch gate cannot flip on a zero-service draw).

Degradation model (``Degradation``) — the paper's "exceptional
conditions" as first-class sweep coordinates:

  * with probability ``p_slow`` a copy is served by a STRAGGLER: its
    service time is inflated ``x slow_factor``;
  * with probability ``p_fail`` a copy BLACKHOLES: it is lost in
    transit — it never occupies its server and never responds. A
    request whose every dispatched copy blackholes never completes;
    the engine reports such cells' summaries over COMPLETED requests
    plus a per-cell ``completed`` count (``TIMEOUT_RETRY``'s final
    attempt is exempt, so retry cells always complete).

  CRN contract: both events are driven by ONE uniform draw per
  (arrival, copy) sampled from a DEDICATED generator stream
  (``queueing._DEGRADE_STREAM``) — never from the service-time
  streams — so healthy cells (``p_slow = p_fail = 0``) consume exactly
  the pre-degradation draws and keep their bits, and degraded cells
  stay CRN-paired with healthy ones copy-for-copy. The draw decides
  blackhole on ``u < p_fail`` and straggler on ``u >= 1 - p_slow``
  (disjoint since ``p_fail + p_slow <= 1``), so raising one
  probability never reshuffles the other's events.

Service models (``ServiceModel``):

  * ``IID`` — the paper's model: each copy's service time is an
    independent draw from the service distribution.
  * ``SERVER_DEPENDENT`` — Shah et al.'s decomposition: a request
    carries a shared component ``X_shared`` (one extra draw per
    arrival, identical for every copy) blended with the per-copy draw:
    ``svc_j = mix * X_shared + (1 - mix) * X_j``. ``mix=0`` is
    bit-identical to ``IID``; ``mix=1`` makes every copy's service time
    identical, so replication buys only queue diversity while still
    multiplying load — the regime where redundancy hurts.

A ``Scenario`` also carries the grid knobs that used to ride
``sweep(..., ks=)`` / ``SimConfig``: the replication factors ``ks``,
the per-request ``client_overhead`` charged when k > 1 (paper Fig 4),
and the ``warmup_frac`` of arrivals dropped from summaries. Machine
shape (``n_servers`` / ``n_arrivals``) stays in ``SimConfig`` — a
Scenario describes *what* is simulated, the config *how much*.

``Scenario`` is a frozen, hashable dataclass with no tensor fields.
Per-cell execution lowers each scenario to
``Variant`` coordinates — one per entry of ``ks`` — which
``repro_torch.core.cellplan`` stores as per-cell policy/model codes next to
(seed, load, k).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Sequence, Union

from repro_torch.core.distributions import ServiceDist


class Policy(enum.IntEnum):
    """Replication-policy codes (per-cell coordinates in the cell plan;
    the CUDA cell-update kernel reads them as per-cell int32 arrays,
    so the values must stay small non-negative ints)."""

    REPLICATE_ALL = 0
    CANCEL_ON_COMPLETE = 1
    REPLICATE_TO_IDLE = 2
    TIMEOUT_RETRY = 3
    HEDGE_AFTER_DELAY = 4


class ServiceModel(enum.IntEnum):
    """Service-model codes (per-cell coordinates in the cell plan; like
    ``Policy`` codes they reach the cell-update kernel as per-cell
    int32 arrays)."""

    IID = 0
    SERVER_DEPENDENT = 1


REPLICATE_ALL = Policy.REPLICATE_ALL
CANCEL_ON_COMPLETE = Policy.CANCEL_ON_COMPLETE
REPLICATE_TO_IDLE = Policy.REPLICATE_TO_IDLE
TIMEOUT_RETRY = Policy.TIMEOUT_RETRY
HEDGE_AFTER_DELAY = Policy.HEDGE_AFTER_DELAY
IID = ServiceModel.IID
SERVER_DEPENDENT = ServiceModel.SERVER_DEPENDENT

# Policies whose dispatch schedule reads the per-variant ``delay`` knob.
TIMED_POLICIES = (Policy.TIMEOUT_RETRY, Policy.HEDGE_AFTER_DELAY)


@dataclasses.dataclass(frozen=True)
class Degradation:
    """Per-copy failure/straggler model (see the module design note).

    ``p_slow``/``p_fail`` are per-COPY probabilities; ``slow_factor``
    multiplies a straggler copy's service time. The healthy default
    (``HEALTHY``) is exactly the pre-degradation engine: both selects
    in ``step_cell`` are inert and no extra randomness is sampled, so
    healthy cells keep the bits of a grid without degradation.
    """

    p_slow: float = 0.0
    slow_factor: float = 1.0
    p_fail: float = 0.0

    def __post_init__(self):
        p_slow, p_fail = float(self.p_slow), float(self.p_fail)
        slow_factor = float(self.slow_factor)
        if not 0.0 <= p_slow <= 1.0 or not 0.0 <= p_fail <= 1.0:
            raise ValueError(
                f"p_slow/p_fail must be in [0, 1], got {p_slow}/{p_fail}")
        if p_slow + p_fail > 1.0:
            raise ValueError(
                "p_slow + p_fail must be <= 1 (the events share one "
                f"uniform draw), got {p_slow} + {p_fail}")
        if slow_factor < 1.0:
            raise ValueError(
                f"slow_factor must be >= 1, got {slow_factor}")
        if p_slow == 0.0:
            slow_factor = 1.0  # inert -> canonical (hash/provenance)
        object.__setattr__(self, "p_slow", p_slow)
        object.__setattr__(self, "p_fail", p_fail)
        object.__setattr__(self, "slow_factor", slow_factor)

    @property
    def healthy(self) -> bool:
        return self.p_slow == 0.0 and self.p_fail == 0.0


HEALTHY = Degradation()

_POLICY_NAMES = {p.name.lower(): p for p in Policy}
_MODEL_NAMES = {m.name.lower(): m for m in ServiceModel}


def parse_policy(name: Union[str, int, Policy]) -> Policy:
    """CLI-friendly lookup: 'cancel_on_complete' -> Policy (case-insensitive)."""
    if isinstance(name, str):
        return _POLICY_NAMES[name.lower()]
    return Policy(name)


def parse_service_model(name: Union[str, int, ServiceModel]) -> ServiceModel:
    """CLI-friendly lookup: 'server_dependent' -> ServiceModel."""
    if isinstance(name, str):
        return _MODEL_NAMES[name.lower()]
    return ServiceModel(name)

@dataclasses.dataclass(frozen=True)
class Variant:
    """One execution variant — a (k, policy, model, mix, overhead,
    degradation, delay) point.

    The engine's cell plan crosses variants with (seed, load): variant
    ``j`` of a scenario grid occupies the plan's k-axis slot ``j``.
    ``delay`` is the TIMED_POLICIES deadline/hedge delay; the
    degradation triple rides as three more per-cell float coordinates.
    """

    k: int
    policy: Policy = Policy.REPLICATE_ALL
    service_model: ServiceModel = ServiceModel.IID
    mix: float = 0.0
    overhead: float = 0.0  # client overhead; the engine charges it iff k > 1
    p_slow: float = 0.0
    slow_factor: float = 1.0
    p_fail: float = 0.0
    delay: float = 0.0
    dist_id: int = 0  # index into the grid's dist union ("which system")

    @property
    def needs_shared_draw(self) -> bool:
        return self.service_model == ServiceModel.SERVER_DEPENDENT

    @property
    def needs_degradation_draw(self) -> bool:
        return self.p_slow > 0.0 or self.p_fail > 0.0


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A declarative point in the replication policy space.

    ``dists`` is one ``ServiceDist`` or a tuple of them; multiple
    distributions stack along the engine's seed axis exactly as
    ``sweep_dists`` did (summaries gain a leading dist axis). A bare
    ``ServiceDist`` is normalized to a 1-tuple, and ``mix`` is
    normalized to 0.0 under ``IID`` (where it is inert) so that
    behaviorally identical scenarios compare, hash, and record
    provenance identically.
    """

    dists: tuple[ServiceDist, ...]
    policy: Policy = Policy.REPLICATE_ALL
    service_model: ServiceModel = ServiceModel.IID
    mix: float = 0.5
    ks: tuple[int, ...] = (1, 2)
    client_overhead: float = 0.0
    warmup_frac: float = 0.1
    degradation: Degradation = HEALTHY
    delay: float = 0.0  # TIMED_POLICIES deadline; normalized to 0 otherwise

    def __post_init__(self):
        d = self.dists
        if isinstance(d, ServiceDist):
            d = (d,)
        d = tuple(d)
        if not d or not all(isinstance(x, ServiceDist) for x in d):
            raise ValueError("Scenario.dists needs >= 1 ServiceDist")
        ks = tuple(int(k) for k in self.ks)
        if not ks or min(ks) < 1:
            raise ValueError(f"Scenario.ks must be >= 1, got {self.ks}")
        if not 0.0 <= float(self.mix) <= 1.0:
            raise ValueError(f"Scenario.mix must be in [0, 1], got {self.mix}")
        if not 0.0 <= float(self.warmup_frac) < 1.0:
            raise ValueError(
                f"Scenario.warmup_frac must be in [0, 1), got "
                f"{self.warmup_frac}")
        model = ServiceModel(self.service_model)
        policy = Policy(self.policy)
        degr = self.degradation
        if not isinstance(degr, Degradation):
            raise TypeError(
                f"Scenario.degradation must be a Degradation, got {degr!r}")
        delay = float(self.delay)
        if delay < 0.0:
            raise ValueError(f"Scenario.delay must be >= 0, got {delay}")
        object.__setattr__(self, "dists", d)
        object.__setattr__(self, "ks", ks)
        object.__setattr__(self, "policy", policy)
        object.__setattr__(self, "service_model", model)
        object.__setattr__(self, "mix",
                           float(self.mix) if model == SERVER_DEPENDENT
                           else 0.0)
        object.__setattr__(self, "client_overhead",
                           float(self.client_overhead))
        object.__setattr__(self, "warmup_frac", float(self.warmup_frac))
        # delay is inert outside TIMED_POLICIES -> canonical 0.0 so
        # behaviorally identical scenarios hash/compare identically.
        object.__setattr__(self, "delay",
                           delay if policy in TIMED_POLICIES else 0.0)

    @classmethod
    def paper_default(cls, dists: Union[ServiceDist,
                                        Sequence[ServiceDist], None] = None,
                      *, ks: tuple[int, ...] = (1, 2),
                      client_overhead: float = 0.0,
                      warmup_frac: float = 0.1) -> "Scenario":
        """The paper's §2.1 model: replicate-all, no cancellation, i.i.d.
        service. Defaults to exponential service (Theorem 1's case)."""
        if dists is None:
            from repro_torch.core.distributions import exponential
            dists = exponential()
        return cls(dists=dists, policy=Policy.REPLICATE_ALL,
                   service_model=ServiceModel.IID, mix=0.0, ks=ks,
                   client_overhead=client_overhead,
                   warmup_frac=warmup_frac)

    @property
    def k_max(self) -> int:
        return max(self.ks)

    @property
    def n_dists(self) -> int:
        return len(self.dists)

    def variant_for(self, k: int) -> Variant:
        """The per-cell coordinates of this scenario at replication ``k``."""
        return Variant(k=int(k), policy=self.policy,
                       service_model=self.service_model, mix=self.mix,
                       overhead=self.client_overhead,
                       p_slow=self.degradation.p_slow,
                       slow_factor=self.degradation.slow_factor,
                       p_fail=self.degradation.p_fail,
                       delay=self.delay)

    def variants(self) -> tuple[Variant, ...]:
        """One ``Variant`` per entry of ``ks`` (the plan's k-axis order)."""
        return tuple(self.variant_for(k) for k in self.ks)


ScenarioLike = Union[Scenario, Sequence[Scenario]]


def combine(scenario: ScenarioLike) -> tuple[tuple[ServiceDist, ...], float,
                                             tuple[Variant, ...]]:
    """Normalize one Scenario or a sequence (a *mixed grid*) for the engine.

    A sequence concatenates each scenario's variants along the plan's
    k-axis — mixed-policy / mixed-model grids run in ONE engine call. All scenarios of a grid must share
    ``warmup_frac`` (they share the warmup cutoff); ``ks`` / policy /
    model / mix / overhead vary per variant.

    Scenarios may also differ in ``dists`` — the HETEROGENEOUS grid:
    each scenario then contributes exactly one distribution ("its
    system"), the distinct dists are deduped into a union tuple, and
    every variant carries its ``dist_id`` index into that union as one
    more per-cell coordinate (``repro_torch.core.queueing`` samples one
    service table per union member and routes each cell to its own —
    this is how different SYSTEMS share one mixed grid).

    Returns ``(dists, warmup_frac, variants)``.
    """
    scns: tuple[Scenario, ...]
    if isinstance(scenario, Scenario):
        scns = (scenario,)
    else:
        scns = tuple(scenario)
    if not scns or not all(isinstance(s, Scenario) for s in scns):
        raise TypeError("expected a Scenario or a non-empty sequence of "
                        f"Scenarios, got {scenario!r}")
    first = scns[0]
    for s in scns[1:]:
        if s.warmup_frac != first.warmup_frac:
            raise ValueError(
                "all scenarios of a mixed grid must share warmup_frac "
                f"(got {s.warmup_frac} vs {first.warmup_frac})")
    if all(s.dists == first.dists for s in scns):
        # homogeneous grid: every cell reads dist stack 0 (legacy path;
        # multi-dist stacks ride the seed axis exactly as before)
        variants = tuple(v for s in scns for v in s.variants())
        return first.dists, first.warmup_frac, variants
    for s in scns:
        if len(s.dists) != 1:
            raise ValueError(
                "scenarios of a heterogeneous mixed grid must each "
                f"carry exactly one dist, got {s.dists}")
    union: list[ServiceDist] = []
    variants_l: list[Variant] = []
    for s in scns:
        d = s.dists[0]
        if d not in union:
            union.append(d)
        did = union.index(d)
        variants_l.extend(dataclasses.replace(v, dist_id=did)
                          for v in s.variants())
    return tuple(union), first.warmup_frac, tuple(variants_l)


def provenance(scenario: ScenarioLike) -> Union[dict, list]:
    """JSON-serializable description of a scenario (benchmark rows record
    this next to each measurement): policy / service model / mix / ks /
    overhead per scenario."""
    if not isinstance(scenario, Scenario):
        return [provenance(s) for s in scenario]
    prov = {"policy": scenario.policy.name,
            "service_model": scenario.service_model.name,
            "mix": scenario.mix, "ks": list(scenario.ks),
            "client_overhead": scenario.client_overhead,
            "dists": [d.name for d in scenario.dists]}
    if not scenario.degradation.healthy or scenario.delay:
        prov["degradation"] = {"p_slow": scenario.degradation.p_slow,
                               "slow_factor": scenario.degradation.slow_factor,
                               "p_fail": scenario.degradation.p_fail}
        prov["delay"] = scenario.delay
    return prov


def any_server_dependent(variants: Iterable[Variant]) -> bool:
    """Whether the engine must sample the extra shared-component column."""
    return any(v.needs_shared_draw for v in variants)


def any_degraded(variants: Iterable[Variant]) -> bool:
    """Whether the engine must sample the per-copy degradation uniforms."""
    return any(v.needs_degradation_draw for v in variants)


def any_timed(variants: Iterable[Variant]) -> bool:
    """Whether the grid contains a TIMED_POLICIES variant: the plain
    chunk body computes its timed-dispatch arm only then (see
    ``cell_update.ref.step_cell``)."""
    return any(v.policy in TIMED_POLICIES for v in variants)


def variant_codes(variants):
    """Per-variant ``(policies, models)`` code lists for
    ``cellplan.make_cell_plan`` — the ONE place Variants lower to plan
    codes. Returns ``(None, None)`` (paper default everywhere) when
    given a legacy ``ks`` tuple of plain ints."""
    variants = tuple(variants)
    if not variants or not isinstance(variants[0], Variant):
        return None, None
    return ([int(v.policy) for v in variants],
            [int(v.service_model) for v in variants])


def variant_dist_ids(variants):
    """Per-variant ``dist_id`` list for ``cellplan.make_cell_plan``, or
    ``None`` (dist 0 everywhere) for a legacy ``ks`` tuple of ints."""
    variants = tuple(variants)
    if not variants or not isinstance(variants[0], Variant):
        return None
    return [int(v.dist_id) for v in variants]


def any_dist_ids(variants) -> bool:
    """Whether the grid is HETEROGENEOUS (some variant reads a dist
    union slot other than 0): the engine samples one service table per
    union member and threads per-cell table indices only then."""
    return any(isinstance(v, Variant) and v.dist_id != 0 for v in variants)

"""In-network packet replication on a k=6 fat-tree (paper §2.4).

Slot-synchronous packet simulation: one loop over time slots, each slot a
few dozen tensor operations over the whole packet table on the device.
Topology: 54 hosts, 18 edge, 18 agg, 9 core switches (3-layer fat-tree,
full bisection). Every directed link serves one 1500 B packet per slot
from a two-level strict-priority queue.

The paper's scheme: the first R packets of every flow are REPLICATED along
an alternate (edge->agg->core) path at strict LOW priority — duplicates can
never delay primary traffic. A packet is delivered when either copy
arrives. Primaries dropped at a full queue are retransmitted after an RTO
with exponential backoff (the §2.4 timeout-avoidance mechanism); dropped
duplicates simply vanish.

Simplifications vs ns-3: no TCP congestion-window dynamics (flows are
paced one packet/slot at the source), drops happen on enqueue past the
buffer cap, per-hop delay = 1 slot. The reproduced phenomenology is Fig
14's: median FCT gain rising to intermediate load then falling, and tail
gains from RTO avoidance.

The PyTorch port of ``repro.core.netsim``: the topology and the workload
are the JAX package's numpy code, bit for bit, and ``_simulate`` is its
``lax.scan`` as a loop over slots. The simulation is integer-only, so its
delivery slots equal the JAX package's exactly, on the CPU and on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import distributions
from repro_torch.device import resolve_device

K = 6
N_HOST = 54
N_EDGE = 18
N_AGG = 18
N_CORE = 9
# directed link ids: we enumerate (host->edge), (edge->agg), (agg->core),
# (core->agg), (agg->edge), (edge->host)
L_HE = 0
L_EA = N_HOST                       # 18 edges x 3 aggs = 54
L_AC = L_EA + 54                    # 18 aggs x 3 cores = 54
L_CA = L_AC + 54
L_AE = L_CA + 54
L_EH = L_AE + 54
N_LINKS = L_EH + N_HOST

MAX_HOPS = 6

# Slots between the checks that end the loop once every packet is
# delivered or dropped (each check reads one flag back from the device).
_DONE_CHECK_SLOTS = 256


def _edge_of(host: int) -> int:
    return host // 3


def _pod_of_edge(e: int) -> int:
    return e // 3


def _links_for_path(src: int, dst: int, up1: int, up2: int) -> list[int]:
    """Directed link ids for src->dst via agg choice up1 (0..2) and core
    choice up2 (0..2). Intra-edge flows shortcut at the edge switch."""
    es, ed = _edge_of(src), _edge_of(dst)
    out = [L_HE + src]
    if es == ed:
        out.append(L_EH + dst)
        return out
    ps, pd = _pod_of_edge(es), _pod_of_edge(ed)
    agg_s = ps * 3 + up1           # agg index within pod ps
    if ps == pd:
        # up to agg, back down to target edge
        out.append(L_EA + es * 3 + up1)
        out.append(L_AE + agg_s * 3 + (ed % 3))
        out.append(L_EH + dst)
        return out
    agg_d = pd * 3 + up1
    out.append(L_EA + es * 3 + up1)
    out.append(L_AC + agg_s * 3 + up2)
    out.append(L_CA + agg_d * 3 + up2)
    out.append(L_AE + agg_d * 3 + (ed % 3))
    out.append(L_EH + dst)
    return out


@dataclasses.dataclass(frozen=True)
class NetConfig:
    n_flows: int = 600
    load: float = 0.4               # fraction of host-link capacity
    mean_flow_pkts: int = 7         # ~10 KB at 1500 B
    elephant_frac: float = 0.05     # heavy flows (data-center mix [8])
    elephant_pkts: int = 200
    replicate_first: int = 8        # R packets duplicated (0 = baseline)
    buffer_pkts: int = 150          # 225 KB / 1500 B
    rto_slots: int = 300            # TCP minRTO >> RTT, the 10 ms analogue
    seed: int = 0


def build_workload(cfg: NetConfig):
    """Packet table (numpy, host side): paths, start slots, flow ids."""
    rng = np.random.default_rng(cfg.seed)
    sizes = np.where(rng.random(cfg.n_flows) < cfg.elephant_frac,
                     cfg.elephant_pkts,
                     1 + rng.geometric(1.0 / cfg.mean_flow_pkts))
    sizes = sizes.astype(np.int64)
    # Poisson flow arrivals so that offered load matches cfg.load
    total_pkts = sizes.sum()
    horizon = int(total_pkts / (N_HOST * cfg.load))
    starts = np.sort(rng.integers(0, max(horizon, 1), cfg.n_flows))
    src = rng.integers(0, N_HOST, cfg.n_flows)
    dst = (src + 1 + rng.integers(0, N_HOST - 1, cfg.n_flows)) % N_HOST

    rows = []  # (flow, seq, start_slot, prio, path..., is_dup)
    for f in range(cfg.n_flows):
        up1, up2 = rng.integers(0, 3), rng.integers(0, 3)
        alt1, alt2 = (up1 + 1 + rng.integers(0, 2)) % 3, rng.integers(0, 3)
        path = _links_for_path(int(src[f]), int(dst[f]), int(up1), int(up2))
        alt_path = _links_for_path(int(src[f]), int(dst[f]), int(alt1),
                                   int(alt2))
        for s in range(int(sizes[f])):
            t0 = int(starts[f]) + s  # paced: one packet per slot
            rows.append((f, s, t0, 0, path, 0))
            if s < cfg.replicate_first:
                rows.append((f, s, t0, 1, alt_path, 1))
    n = len(rows)
    paths = np.full((n, MAX_HOPS), -1, np.int32)
    meta = np.zeros((n, 5), np.int32)  # flow, seq, start, prio, is_dup
    lens = np.zeros((n,), np.int32)
    for i, (f, s, t0, prio, path, dup) in enumerate(rows):
        meta[i] = (f, s, t0, prio, dup)
        lens[i] = len(path)
        paths[i, :len(path)] = path
    return meta, paths, lens, sizes, starts


def _simulate(meta, paths, lens, *, n_slots: int, buffer_pkts: int,
              rto_slots: int, device="cuda") -> torch.Tensor:
    """Advance the packet table slot by slot on ``device``. Returns the
    delivery slots (n,) int64 on ``device`` (-1 if never delivered).

    Each slot serves, per link, the waiting packet that is least in
    (priority, ready slot, row): three rounds of ``scatter_reduce_`` with
    ``"amin"`` over the links, each prefilled with ``1 << 30``. Queue
    occupancy is a ``scatter_add_`` of the waiting packets; the path
    lookups are ``gather``s. Rows whose packet is delivered or dropped
    are parked on the spare link ``N_LINKS``. The loop ends early once
    every row is delivered or dropped: no later slot changes anything.
    On the CPU the loop runs on one intra-op thread: its tensors are
    small, and a thread pool only adds a barrier to each of its ~60 ops
    a slot (600 slots of a 10,800-row table on an 8-core CPU shared with
    five busy processes: 52.7 s on 8 threads, 0.80 s on one)."""
    dev = resolve_device(device)
    threads = torch.get_num_threads()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    try:
        return _simulate_slots(meta, paths, lens, n_slots, buffer_pkts,
                               rto_slots, dev)
    finally:
        torch.set_num_threads(threads)


def _simulate_slots(meta, paths, lens, n_slots: int, buffer_pkts: int,
                    rto_slots: int, dev: torch.device) -> torch.Tensor:
    """The slot loop of ``_simulate`` on ``dev``."""

    def table(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(torch.int64)

    meta, paths, lens = table(meta), table(paths), table(lens)
    n = meta.shape[0]
    prio, is_dup = meta[:, 3], meta[:, 4] == 1
    hop = torch.zeros(n, dtype=torch.int64, device=dev)
    ready = meta[:, 2].clone()
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    delivered = torch.full((n,), -1, dtype=torch.int64, device=dev)
    retries = torch.zeros(n, dtype=torch.int64, device=dev)
    uid = torch.arange(n, dtype=torch.int64, device=dev)
    park = torch.full((n,), N_LINKS, dtype=torch.int64, device=dev)
    big = 1 << 30

    def path_link(h):
        # rows past their path (delivered ones) read a clamped hop; their
        # link is parked by the caller
        return paths.gather(1, h.clamp(max=MAX_HOPS - 1)[:, None])[:, 0]

    def seg_min(vals, mask, link):
        """Per link, the least of ``vals`` over the rows of ``mask``."""
        return torch.full((N_LINKS + 1,), big, dtype=torch.int64,
                          device=dev).scatter_reduce_(
            0, link, torch.where(mask, vals, big), "amin")

    for t in range(n_slots):
        if t % _DONE_CHECK_SLOTS == 0 and not bool(
                (alive & (delivered < 0)).any()):
            break
        in_flight = alive & (delivered < 0) & (ready <= t)
        cur_link = torch.where(in_flight, path_link(hop), park)
        # queue occupancy per link (all waiting packets)
        occ = torch.zeros(N_LINKS + 1, dtype=torch.int64,
                          device=dev).scatter_add_(0, cur_link,
                                                   in_flight.long())
        best_prio = seg_min(prio, in_flight, cur_link)
        cand = in_flight & (prio == best_prio[cur_link])
        best_ready = seg_min(ready, cand, cur_link)
        cand = cand & (ready == best_ready[cur_link])
        first_uid = seg_min(uid, cand, cur_link)
        served = cand & (uid == first_uid[cur_link]) & (cur_link < N_LINKS)

        new_hop = torch.where(served, hop + 1, hop)
        done = served & (new_hop >= lens)
        delivered = torch.where(done & (delivered < 0), t, delivered)

        # next-queue overflow: drop or schedule retransmit
        entering = served & ~done
        nxt_occ = occ[torch.where(entering, path_link(new_hop), park)]
        overflow = entering & (nxt_occ >= buffer_pkts)
        # duplicates vanish on drop; primaries back off and retransmit
        retrans = overflow & ~is_dup
        alive = alive & ~(overflow & is_dup)
        retries = retries + retrans.long()
        backoff = rto_slots * torch.bitwise_left_shift(
            torch.ones_like(retries), retries.clamp(max=6))
        ready = torch.where(retrans, t + backoff,
                            torch.where(served, t + 1, ready))
        hop = torch.where(retrans, 0, torch.where(overflow, hop, new_hop))
    return delivered


def default_n_slots(cfg: NetConfig, sizes, starts) -> int:
    """The simulation's horizon: the last start, three times the largest
    flow, and eight RTOs of slack."""
    return int(starts.max() + sizes.max() * 3 + 8 * cfg.rto_slots)


def flow_completion_times(cfg: NetConfig, n_slots: int | None = None,
                          device="cuda"):
    """Run the sim; returns (fct_slots (n_flows,), sizes, short_mask,
    undelivered_mask) as numpy arrays. FCTs are RELATIVE slots (completion
    - start + 1); undelivered flows are censored at the horizon in the
    same units (n_slots - start)."""
    meta, paths, lens, sizes, starts = build_workload(cfg)
    if n_slots is None:
        n_slots = default_n_slots(cfg, sizes, starts)
    delivered = _simulate(meta, paths, lens, n_slots=n_slots,
                          buffer_pkts=cfg.buffer_pkts,
                          rto_slots=cfg.rto_slots, device=device)
    delivered = delivered.cpu().numpy()
    flow, seq, start, prio, is_dup = meta.T
    n_flows = cfg.n_flows
    # min over copies / max over packets: scatter each delivered copy's
    # slot into a dense (flow, seq) table with ``np.minimum.at``
    # (duplicates of a packet reduce to the earliest arrival), then
    # reduce per flow.
    big = np.int64(1) << 40
    max_pkts = int(sizes.max())
    best = np.full((n_flows, max_pkts), big)
    ok = delivered >= 0
    np.minimum.at(best, (flow[ok], seq[ok]), delivered[ok].astype(np.int64))
    valid = np.arange(max_pkts)[None, :] < sizes[:, None]
    undelivered = ((best == big) & valid).any(axis=1)
    last = np.where(valid, best, -big).max(axis=1)
    # Censor undelivered flows at the horizon IN RELATIVE SLOTS
    # (n_slots - starts) so they share units with delivered flows'
    # last - starts + 1.
    fct = np.where(undelivered, (float(n_slots) - starts).astype(np.float64),
                   last.astype(np.float64) - starts + 1.0)
    short = sizes <= 10
    return fct, sizes, short, undelivered


def empirical_fct_dist(cfg: NetConfig, n_slots: int | None = None, *,
                       short_only: bool = True, n_quantiles: int = 256,
                       device="cuda"):
    """Fit the simulated flow-completion times into a quantile-table
    ``EmpiricalDist`` (``distributions.empirical``): the Fig 14 tail
    analysis reads the short-flow FCT law off this table (its
    ``exceedance`` gives P[FCT > x] in slot units via ``scale``).
    ``short_only`` restricts the fit to the paper's short flows (<= 10
    packets); undelivered flows keep their horizon-censored FCT, like the
    raw output."""
    fct, sizes, short, undelivered = flow_completion_times(cfg, n_slots,
                                                           device=device)
    sel = fct[short] if short_only else fct
    kind = "short" if short_only else "all"
    return distributions.empirical(sel, n_quantiles=n_quantiles,
                                   name=f"netsim_fct[{kind}]")

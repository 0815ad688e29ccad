"""Plain PyTorch version of the fused cell update.

``step_cell`` is the single-arrival physics of the replication DES for a
batch of cells — free-time gather, policy/model selects, occupancy
scatter, response min — and ``cell_update_ref`` runs one chunk of
arrivals through it. It is the bit anchor of the port: the CUDA kernel
(``repro_torch/csrc/cell_update.cu``) must equal it bit for bit on the
card, and on the CPU it is held bit for bit against the JAX package's
``repro.kernels.cell_update.ref.cell_update_ref`` on injected inputs.
On the card the chunk's step loop replays one captured CUDA graph a step
(``_steps_on_graph``: the same ops, the step index read from a device
counter); on the CPU it is an eager Python loop.

Bit rules:

  * Every float op is elementwise or a min/max over the small copy
    axis, so no sum depends on an order. Each multiply and add is its
    own eager op, so nothing is contracted into an FMA — do not wrap
    this module in ``torch.compile`` and do not replace a multiply-add
    with a fused op such as ``addcmul``.
  * The Kahan update is GATED on the warmup weight via selects: a
    zero-weight step leaves (ssum, comp) bitwise untouched, which makes
    the summaries invariant to trailing zero-weight padding.
  * The occupancy scatter writes one copy at a time in copy order, so a
    duplicated server (zero-padded steps) keeps the last copy's value on
    every device, as the JAX reference's scatter does.
  * Selects are exact, so an arm whose policy no cell of the batch uses
    is skipped: the result is the same bits as selecting it away.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.scenario import Policy, ServiceModel
from repro_torch.kernels.hist_sketch import ops as hist_ops
from repro_torch.kernels.hist_sketch.ref import hist_accum_ref

# TIMEOUT_RETRY exponential backoff: attempt j dispatches at
# t + delay * sum_{i<j} min(2**i, _BACKOFF_CAP). The cap bounds the
# inter-attempt wait at 8 deadlines (offsets 0, 1, 3, 7, 15, 23, ...).
_BACKOFF_CAP = 8.0

_INF = math.inf


def retry_offsets(k_max: int) -> list[float]:
    """Backoff-offset coefficients per attempt (exact small floats,
    shared by this module and the CUDA kernel's integer recurrence)."""
    c, out = 0.0, []
    for j in range(k_max):
        out.append(c)
        c += min(2.0 ** j, _BACKOFF_CAP)
    return out


def service_times(svc, shared, degr, model, mix, p_slow, slow_factor,
                  p_fail):
    """Per-copy served times and blackhole survival, ``svc``/``degr``
    (..., k) against per-cell knobs broadcast on the leading axes.

    SERVER_DEPENDENT (Shah et al.) blends the shared request component
    into every copy: ``mix * shared + (1 - mix) * svc`` — two rounded
    products and a rounded sum. A straggler copy (``degr >= 1 -
    p_slow``) is inflated by ``slow_factor``; a copy with ``degr <
    p_fail`` blackholes. Healthy cells (``degr = 0``) pass through both
    selects bitwise unchanged."""
    blend = mix * shared + (1.0 - mix) * svc
    svc = torch.where(model == int(ServiceModel.SERVER_DEPENDENT), blend, svc)
    svc = torch.where(degr >= 1.0 - p_slow, svc * slow_factor, svc)
    return svc, degr >= p_fail


def step_cell(free, t, srv, svc, alive, mask, ovh, policy, *, arms,
              disp_t=None, alive_eff=None, fire_all=None):
    """One arrival at a batch of C cells, updating ``free`` (C, N) IN
    PLACE. ``t`` (C,) arrival times; ``srv`` (C, k) int64 copy servers;
    ``svc`` / ``alive`` (C, k) from ``service_times``; ``mask`` (C, k)
    prefix copy masks; ``ovh`` / ``policy`` (C,). Returns the response
    (C,), ``inf`` where every dispatched copy blackholed.

    ``arms`` is the set of ``Policy`` codes present in the batch (see
    the module note on skipped arms). The timed policies take the
    per-copy dispatch times ``disp_t``, the retry-exempt survival
    ``alive_eff`` and the ``fire_all`` flag (C,).

    Policies: REPLICATE_ALL — every surviving copy runs to completion;
    CANCEL_ON_COMPLETE — losers vacate at the winner's finish
    (``max(cur, t_win)``); REPLICATE_TO_IDLE — the primary always
    dispatches, extras only to servers idle at ``t``; TIMEOUT_RETRY /
    HEDGE_AFTER_DELAY — copy j fires at ``disp_t[j]`` only if no earlier
    surviving copy has finished by then (``fire_all`` forces all)."""
    cur = torch.gather(free, 1, srv)
    tc = t[:, None]
    finish = torch.maximum(cur, tc) + svc
    live = mask & alive
    t_win = torch.where(live, finish, _INF).amin(dim=1)
    new_val = torch.where(live, finish, cur)
    resp_at = t_win
    if Policy.CANCEL_ON_COMPLETE in arms:
        is_c = (policy == int(Policy.CANCEL_ON_COMPLETE))[:, None]
        val = torch.where(live, torch.maximum(cur, t_win[:, None]), cur)
        new_val = torch.where(is_c, val, new_val)
    if Policy.REPLICATE_TO_IDLE in arms:
        is_i = policy == int(Policy.REPLICATE_TO_IDLE)
        primary = torch.arange(srv.shape[1], device=srv.device) == 0
        disp = mask & (primary | (cur <= tc)) & alive
        new_val = torch.where(is_i[:, None],
                              torch.where(disp, finish, cur), new_val)
        resp_at = torch.where(
            is_i, torch.where(disp, finish, _INF).amin(dim=1), resp_at)
    if Policy.TIMEOUT_RETRY in arms or Policy.HEDGE_AFTER_DELAY in arms:
        is_t = ((policy == int(Policy.TIMEOUT_RETRY))
                | (policy == int(Policy.HEDGE_AFTER_DELAY)))
        fired = torch.maximum(cur, disp_t) + svc
        best = torch.full_like(t, _INF)
        made = []
        for j in range(srv.shape[1]):
            made_j = mask[:, j] if j == 0 else (
                mask[:, j] & (fire_all | (best > disp_t[:, j])))
            made_j = made_j & alive_eff[:, j]
            best = torch.minimum(best, torch.where(made_j, fired[:, j], _INF))
            made.append(made_j)
        val = torch.where(torch.stack(made, dim=1), fired, cur)
        new_val = torch.where(is_t[:, None], val, new_val)
        resp_at = torch.where(is_t, best, resp_at)
    for j in range(srv.shape[1]):  # copy order: last write wins
        free.scatter_(1, srv[:, j:j + 1], new_val[:, j:j + 1])
    return resp_at - t + ovh


def kahan_fold(ssum, comp, resp, w):
    """One gated Kahan step: the 0/1 weight ``w`` gates the whole update
    via selects, so a zero-weight step leaves (ssum, comp) bitwise
    untouched. Kahan-compensated f32 accumulation keeps the mean of
    ~1e5+ terms exact to float32, which is the signal threshold
    estimation keys on."""
    y = resp - comp
    tot = ssum + y
    comp_new = (tot - ssum) - y
    live = w > 0
    return torch.where(live, tot, ssum), torch.where(live, comp_new, comp)


def cell_update_ref(free, ssum, comp, cnt, hist, cum, warm, valid, servers,
                    services, seed_idx, rates, k_mask, ovh, policy_code,
                    model_code, mix, p_slow, slow_factor, p_fail, delay,
                    svc_idx=None, *, n_bins: int, block: int,
                    has_shared: bool = False, has_timed: bool = False,
                    has_dists: bool = False):
    """One chunk on the flat cell axis; returns new ``(free, ssum, comp,
    cnt, hist)`` with ``free`` NOT yet rebased (the caller rebases).

    ``cum`` (S, T) cumulative arrival offsets from the chunk start,
    ``warm`` (T,) 0/1 post-warmup weights, ``valid`` (T,) 0/1 real-step
    flags (0 only on padding: the timed policies' delay is zeroed there,
    so a deferred dispatch cannot push a free time past the chunk end),
    ``servers`` (S, T, k_max) and ``services`` (S or D*S, T, n_svc) the
    sampled inputs, laid out ``[k_max copies][shared if has_shared][k_max
    degradation uniforms if present]``. Per-cell plan parameters are
    (C,) (``k_mask`` (C, k_max)). ``has_dists`` routes the SERVICE gather
    through ``svc_idx`` instead of ``seed_idx``. ``hist`` of shape (0, 0)
    skips the sketch; otherwise responses are binned per ``block`` steps
    (``T % block == 0``) and accumulated with the plain ``hist_accum``.

    ``cnt`` accumulates COMPLETED post-warmup responses: a request whose
    every copy blackholed (``resp = inf``) gets weight 0 for the mean, the
    count and the histogram.
    """
    k_max = k_mask.shape[1]
    n_base = k_max + (1 if has_shared else 0)
    has_degr = services.shape[-1] > n_base
    need_hist = hist.numel() > 0
    T = cum.shape[1]
    if need_hist and T % block:
        raise ValueError(f"T={T} is not a multiple of block={block}")
    free = free.clone()
    # Everything that does not depend on the carry is elementwise, so it
    # is computed for the whole chunk at once (same bits as per step).
    t_all = cum[seed_idx] / rates[:, None]                     # (C, T)
    srv_all = servers[seed_idx].to(torch.int64)                # (C, T, k)
    svc_c = services[svc_idx if has_dists else seed_idx]       # (C, T, n_svc)
    shared = svc_c[:, :, k_max if has_shared else 0, None]
    degr = (svc_c[:, :, n_base:n_base + k_max] if has_degr
            else torch.zeros_like(svc_c[:, :, :k_max]))
    svc_all, alive_all = service_times(
        svc_c[:, :, :k_max], shared, degr, model_code[:, None, None],
        mix[:, None, None], p_slow[:, None, None],
        slow_factor[:, None, None], p_fail[:, None, None])
    arms = set(int(p) for p in torch.unique(policy_code).tolist())
    timed = {}
    if has_timed:
        is_retry = (policy_code == int(Policy.TIMEOUT_RETRY))[:, None]
        iota = torch.arange(k_max, device=cum.device)
        coeff = torch.where(
            is_retry, torch.tensor(retry_offsets(k_max), device=cum.device),
            iota.to(torch.float32))                            # (C, k)
        d_eff = torch.where(valid[None, :] > 0, delay[:, None], 0.0)  # (C, T)
        timed = dict(
            disp_t=t_all[:, :, None] + d_eff[:, :, None] * coeff[:, None, :],
            alive_eff=alive_all | (is_retry & (
                iota == k_mask.sum(dim=1, keepdim=True) - 1))[:, None, :],
            fire_all=d_eff <= 0.0)
    elif arms & {int(Policy.TIMEOUT_RETRY), int(Policy.HEDGE_AFTER_DELAY)}:
        raise ValueError("timed-policy cells need has_timed=True")

    resp_blk = torch.empty((block if need_hist else 0, free.shape[0]),
                           dtype=torch.float32, device=cum.device)
    w_blk = torch.empty_like(resp_blk)

    def step(at):
        """Step ``at`` of the chunk: ``at(x, dim)`` takes it from ``x``.
        Updates ``free`` in place; returns (response, post-warmup weight)."""
        kw = {k: at(v, 1) for k, v in timed.items()}
        resp = step_cell(free, at(t_all, 1), at(srv_all, 1), at(svc_all, 1),
                         at(alive_all, 1), k_mask, ovh, policy_code,
                         arms=arms, **kw)
        return resp, at(warm, 0) * torch.isfinite(resp).to(torch.float32)

    def flush(hist):
        idx = hist_ops.bin_indices(resp_blk, w_blk, n_bins=n_bins)
        return hist + hist_accum_ref(idx, n_bins=n_bins)

    if cum.is_cuda:
        ssum, comp, cnt, hist = _steps_on_graph(
            step, flush, T, ssum, comp, cnt, hist, resp_blk, w_blk, block)
        return free, ssum, comp, cnt, hist
    for s in range(T):
        resp, w_live = step(lambda x, dim: x.select(dim, s))
        ssum, comp = kahan_fold(ssum, comp, resp, w_live)
        cnt = cnt + w_live
        if need_hist:
            resp_blk[s % block] = resp
            w_blk[s % block] = w_live
            if s % block == block - 1:
                hist = flush(hist)
    return free, ssum, comp, cnt, hist


def _steps_on_graph(step, flush, n_steps, ssum, comp, cnt, hist, resp_blk,
                    w_blk, block):
    """``cell_update_ref``'s step loop on the card: one step — the same
    ops as the eager loop, the step index read from a device counter — is
    captured into a CUDA graph and replayed once a step, so the host
    launches one graph a step instead of some fifty small kernels (the
    eager loop is paced by the host at ~0.3 ms a step). Step 0 runs
    eagerly first, on a side stream, as capture wants. The histogram's
    block fold stays eager, after every ``block`` steps. Returns the new
    (ssum, comp, cnt, hist); ``step`` updates ``free`` in place."""
    dev = ssum.device
    need_hist = resp_blk.shape[0] > 0
    s_dev = torch.zeros(1, dtype=torch.int64, device=dev)
    ssum, comp, cnt = ssum.clone(), comp.clone(), cnt.clone()

    def body():
        resp, w_live = step(
            lambda x, dim: x.index_select(dim, s_dev).squeeze(dim))
        new_ssum, new_comp = kahan_fold(ssum, comp, resp, w_live)
        ssum.copy_(new_ssum)
        comp.copy_(new_comp)
        cnt.copy_(cnt + w_live)
        if need_hist:
            slot = torch.remainder(s_dev, block)
            resp_blk.index_copy_(0, slot, resp[None])
            w_blk.index_copy_(0, slot, w_live[None])
        s_dev.add_(1)

    def after(s, hist):
        if need_hist and s % block == block - 1:
            hist = flush(hist)
        return hist

    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    hist = after(0, hist)
    if n_steps > 1:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body()
        for s in range(1, n_steps):
            graph.replay()
            hist = after(s, hist)
    return ssum, comp, cnt, hist

"""Carry the JAX package's numpy state into the port, and back.

What crosses from the reference: a chunk's sampled inputs
(``unit_gaps`` or ``cum``, ``servers``, ``services``), the per-cell
carry (``free``, ``ssum``, ``comp``, ``cnt``, ``hist``), the cell-plan
coordinates, an LM's weights (``lm_params_from_numpy``: every leaf of
the JAX tree under its own dotted path, whatever the family — untied
heads, codebook tables and heads, ``patch_proj``, the MoE's router and
expert stacks, the MLA projections, ``mtp``) and its decode caches
(``lm_cache_from_numpy`` / ``lm_cache_to_numpy``: attention, MLA latent,
recurrent and SSD caches alike) and an optimizer's state
(``opt_state_from_numpy``: AdamW's moments and master, Adafactor's
factored moments per JAX leaf); gradients cross as weights do. Everything
arrives as numpy arrays (the tests pull them out of JAX with
``np.asarray``), so this module needs neither JAX nor ``repro``.

bf16: ``np.asarray`` of a JAX bf16 array has the ``ml_dtypes``
``bfloat16`` dtype, which ``torch.from_numpy`` refuses. ``to_tensor``
moves its bits through a ``uint16`` view, and ``to_numpy`` hands a bf16
tensor back as ``bfloat16`` where numpy knows that dtype (``ml_dtypes``
is loaded, as JAX loads it) and as exact float32 values where it does
not. Neither imports ``ml_dtypes``.

``NumpySampler`` replays pre-drawn numpy chunks through the port's
engine, unsharded or sharded, so one set of draws can be pushed through
both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cellplan
from repro_torch.device import resolve_device

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.int64): torch.int64,
           np.dtype(np.bool_): torch.bool}


def to_tensor(x, device="cuda") -> torch.Tensor:
    """A numpy array (or array-like) as a tensor of the same dtype and
    bits on ``device`` — CUDA unless the CPU is asked for, as at every
    entry point of the port (``repro_torch.device.resolve_device``)."""
    device = resolve_device(device)
    a = np.array(x, order="C")  # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device=device)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype}")
    return torch.from_numpy(a).to(device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as a numpy array of the same dtype and bits
    (never a view: the port updates its decode caches in place); bf16 as
    numpy ``bfloat16`` where numpy knows it, else as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        return t.to(torch.float32).numpy()
    return t.view(torch.uint16).numpy().view(bf16).copy()


def carry_from_numpy(free, ssum, comp, cnt, hist, device="cuda"):
    """The per-cell carry ``(free (C,N), ssum, comp, cnt (C,), hist (C,
    n_bins) or (0, 0))`` as float32 tensors."""
    return tuple(to_tensor(np.asarray(x, np.float32), device)
                 for x in (free, ssum, comp, cnt, hist))


def chunk_from_numpy(gaps_or_cum, servers, services, device="cuda"):
    """A chunk's sampled inputs: float32 (S, T) gaps or cumulative
    offsets, int32 (S, T, k_max) copy sets, float32 (S_svc, T, n_svc)
    service columns."""
    return (to_tensor(np.asarray(gaps_or_cum, np.float32), device),
            to_tensor(np.asarray(servers, np.int32), device),
            to_tensor(np.asarray(services, np.float32), device))


def plan_from_numpy(n_seeds: int, n_loads: int, n_ks: int, *, seed_idx,
                    load_idx, k_idx, valid, policy_code, model_code,
                    dist_id, device="cuda") -> cellplan.CellPlan:
    """A ``CellPlan`` from the reference plan's coordinates (numpy)."""
    seed_idx = np.asarray(seed_idx)
    n_cells = n_seeds * n_loads * n_ks

    def long(x):
        return to_tensor(np.asarray(x, np.int64), device)

    return cellplan.CellPlan(
        n_seeds=n_seeds, n_loads=n_loads, n_ks=n_ks, n_cells=n_cells,
        n_padded=int(seed_idx.shape[0]), seed_idx=long(seed_idx),
        load_idx=long(load_idx), k_idx=long(k_idx),
        valid=to_tensor(np.asarray(valid, bool), device),
        policy_code=to_tensor(np.asarray(policy_code, np.int32), device),
        model_code=to_tensor(np.asarray(model_code, np.int32), device),
        dist_id=long(dist_id))


class NumpySampler:
    """Replays pre-drawn chunks ``[(unit_gaps (S,T), servers (S,T,k),
    services (S_svc,T,n_svc)), ...]`` (numpy) through the port's engine:
    ``sampler(c, t)`` returns chunk ``c`` as tensors on ``device``, and
    ``sampler.rows(c, t, seed_rows, svc_rows)`` only those global rows of
    it, as the sharded executor asks (``queueing.ChunkSampler.rows``)."""

    def __init__(self, chunks, device="cuda"):
        self.chunks = list(chunks)
        self.device = resolve_device(device)

    def __call__(self, c: int, t: int):
        return self.rows(c, t, slice(None), slice(None))

    def rows(self, c: int, t: int, seed_rows, svc_rows):
        gaps, servers, services = self.chunks[c]
        if np.shape(gaps)[1] != t:
            raise ValueError(f"chunk {c} holds {np.shape(gaps)[1]} steps, "
                             f"the engine asked for {t}")
        def take(x, r):
            return np.asarray(x)[r if isinstance(r, slice)
                                 else np.asarray(r, np.int64)]

        return chunk_from_numpy(take(gaps, seed_rows),
                                take(servers, seed_rows),
                                take(services, svc_rows), self.device)


# Argument order of ``cell_update_ref`` / ``cell_update`` in both packages.
CELL_UPDATE_ARGS = ("free", "ssum", "comp", "cnt", "hist", "cum", "warm",
                    "valid", "servers", "services", "seed_idx", "rates",
                    "k_mask", "ovh", "policy_code", "model_code", "mix",
                    "p_slow", "slow_factor", "p_fail", "delay", "svc_idx")


# Arms of the cell update that the parity checks cover (keyword
# arguments of ``synthetic_chunk``): every policy x service model, a
# degraded grid, the timed policies with blackholes, a heterogeneous
# grid and ragged padded chunks, with and without the sketch. ``mix =
# 0.5`` and delays whose products with the retry backoff coefficients
# are exact keep the comparison with the JAX package on the CPU free of
# XLA's multiply-add contraction.
CELL_UPDATE_ARMS = {
    "paper_default": dict(k_max=2),
    "policies_iid_timed": dict(k_max=3, policies=(0, 1, 2, 3, 4),
                               delay=0.75),
    "policies_x_server_dependent": dict(k_max=2, policies=(0, 1, 2, 3, 4),
                                        models=(0, 1), mix=0.5, delay=0.5),
    "degraded": dict(k_max=2, policies=(0, 1, 2, 3, 4),
                     degraded=(0.1, 4.0, 0.05), delay=0.5),
    "timed_ragged_blackholes": dict(k_max=3, policies=(3, 4),
                                    degraded=(0.0, 1.0, 0.2), delay=0.25,
                                    pad=300),
    "has_dists": dict(k_max=2, policies=(0, 1, 2), models=(0, 1),
                      n_dists=3, mix=0.5),
    "ragged_no_sketch": dict(k_max=2, policies=(0, 2), pad=123, hist=False),
    "k1_ragged_sketch": dict(k_max=1, policies=(0, 1, 2), pad=200),
}


# Edges of the CUDA kernel's protocol (keyword arguments of
# ``synthetic_chunk``, ``steps`` included): chunk lengths that are not a
# multiple of its tiles of 16-64 steps, every K template up to 16 copies,
# the largest free-time grid, blocks over many seed and service rows,
# sketch widths with skipped steps, and a chunk longer than the interval
# at which its 16-bit histogram counters are flushed. No case pads more
# steps than its last, partial tile holds at any tile (T mod 16, 32 and 64
# are 12/28/60 at 700 steps, 12/28/28 at 1,500, 9 at 8,969), so that tile
# always holds counted responses.
CELL_UPDATE_EDGES = {
    **{f"T{t}": dict(steps=t, n_cells=40, k_max=3, policies=(0, 1, 2, 3, 4),
                     degraded=(0.1, 4.0, 0.05), delay=0.5, warmup=0)
       for t in (1, 63, 777, 4097)},
    **{f"k{k}": dict(steps=700, n_cells=48, k_max=k,
                     policies=(0, 1, 2, 3, 4), models=(0, 1), delay=0.5,
                     degraded=(0.1, 4.0, 0.05), pad=5)
       for k in (1, 2, 3, 4, 5, 8, 9, 16)},
    "max_servers": dict(steps=300, n_cells=40, k_max=2, policies=(0, 1, 2),
                        n_servers=16_384),
    "has_dists_1440": dict(steps=1000, n_cells=1440, k_max=2,
                           policies=(0, 1, 2), models=(0, 1), n_dists=15),
    **{f"bins{nb}": dict(steps=1500, n_cells=64, k_max=2, n_bins=nb,
                         warmup=300, pad=7, degraded=(0.0, 1.0, 0.1))
       for nb in (100, 256, 2048)},
    "past_flush": dict(steps=8192 + 777, n_cells=8, k_max=2, pad=4),
}


def synthetic_chunk(seed: int, *, n_cells: int = 12, n_seeds: int = 2,
                    n_servers: int = 6, steps: int = 1024, k_max: int = 2,
                    policies=(0,), models=(0,), mix: float = 0.5,
                    degraded: tuple[float, float, float] | None = None,
                    delay: float = 0.0, n_dists: int = 1, pad: int = 0,
                    warmup: int = 100, n_bins: int = 2048,
                    hist: bool = True):
    """Injected inputs for one ``cell_update`` chunk, drawn with numpy
    from ``seed``: ``(args, static)`` where ``args`` maps the names of
    ``CELL_UPDATE_ARGS`` to numpy arrays and ``static`` holds the keyword
    flags (``n_bins``, ``has_shared``, ``has_timed``, ``has_dists``).

    Cells cycle through ``policies`` / ``models`` codes, k = 1 + c %
    k_max copies, seed row c % n_seeds and dist table c % n_dists.
    ``degraded=(p_slow, slow_factor, p_fail)`` appends the per-copy
    degradation uniforms; the last ``pad`` steps are zero-padded the way
    the engine pads a ragged chunk. The carry starts from nonzero values
    (free times of both signs, a running sum and histogram)."""
    rng = np.random.default_rng(seed)
    C, S, N, T = n_cells, n_seeds, n_servers, steps
    c = np.arange(C)
    policy = np.asarray(policies, np.int32)[c % len(policies)]
    model = np.asarray(models, np.int32)[c % len(models)]
    has_shared = bool((model == 1).any())
    has_timed = bool(np.isin(policy, (3, 4)).any())
    valid = (np.arange(T) < T - pad).astype(np.float32)
    gaps = rng.exponential(size=(S, T)).astype(np.float32) * valid
    cum = np.cumsum(gaps, axis=1, dtype=np.float32)
    first = rng.integers(0, N, size=(S, T, 1))
    offs = np.argsort(rng.random((S, T, N - 1)), axis=2)[..., :k_max - 1]
    servers = (np.concatenate([first, (first + 1 + offs) % N], axis=2)
               * valid[None, :, None]).astype(np.int32)
    n_svc = k_max + int(has_shared) + (k_max if degraded else 0)
    services = rng.exponential(size=(n_dists * S, T, n_svc)).astype(
        np.float32)
    if degraded:
        services[..., -k_max:] = rng.random((n_dists * S, T, k_max))
    services *= valid[None, :, None]
    kc = 1 + c % k_max
    p_slow, slow_factor, p_fail = degraded or (0.0, 1.0, 0.0)

    def per_cell(v):
        return np.full(C, v, np.float32)

    args = dict(
        free=rng.uniform(-0.5, 0.5, (C, N)).astype(np.float32),
        ssum=rng.uniform(0.0, 100.0, C).astype(np.float32),
        comp=rng.uniform(-1e-6, 1e-6, C).astype(np.float32),
        cnt=rng.integers(0, 100, C).astype(np.float32),
        hist=(rng.integers(0, 3, (C, n_bins)).astype(np.float32) if hist
              else np.zeros((0, 0), np.float32)),
        cum=cum, valid=valid,
        warm=(valid * (np.arange(T) >= warmup)).astype(np.float32),
        servers=servers, services=services,
        seed_idx=(c % S).astype(np.int32),
        rates=(N * rng.uniform(0.05, 0.3, C)).astype(np.float32),
        k_mask=np.arange(k_max)[None, :] < kc[:, None],
        ovh=np.where(kc > 1, 0.05, 0.0).astype(np.float32),
        policy_code=policy, model_code=model, mix=per_cell(mix),
        p_slow=per_cell(p_slow), slow_factor=per_cell(slow_factor),
        p_fail=per_cell(p_fail), delay=per_cell(delay),
        svc_idx=((c % n_dists) * S + c % S).astype(np.int32))
    static = dict(n_bins=n_bins, has_shared=has_shared, has_timed=has_timed,
                  has_dists=n_dists > 1)
    return args, static


# ---------------------------------------------------------------------------
# LM weights and caches
# ---------------------------------------------------------------------------


def _layer_index(cfg, group: str, i: int, r: int = 0) -> int:
    """Layer-order index of the JAX tree's ``prefix[i]``, ``blocks/pos{i}``
    at repeat ``r``, or ``suffix[i]``."""
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    if group == "prefix":
        return i
    if group == "blocks":
        return n_pre + r * n_pat + i
    return n_pre + cfg.repeats * n_pat + i


def _flat(tree, prefix: str = ""):
    """(dotted path, leaf) pairs of nested dicts and lists (an entry of a
    list by its index)."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flat(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flat(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _per_layer(tree, cfg):
    """The JAX tree's ``prefix``/``blocks``/``suffix`` groups as (layer
    index, {dotted path: leaf}) pairs, unstacking ``blocks/pos{i}`` along
    its leading repeats axis."""
    for i, sub in enumerate(tree.get("prefix", [])):
        yield _layer_index(cfg, "prefix", i), dict(_flat(sub))
    for name, sub in tree.get("blocks", {}).items():
        i = int(name[len("pos"):])
        stacked = dict(_flat(sub))
        for r in range(cfg.repeats):
            yield _layer_index(cfg, "blocks", i, r), {
                k: np.asarray(v)[r] for k, v in stacked.items()}
    for i, sub in enumerate(tree.get("suffix", [])):
        yield _layer_index(cfg, "suffix", i), dict(_flat(sub))


def lm_params_from_numpy(params, cfg, device="cuda") -> dict:
    """The JAX ``lm.init`` pytree (numpy leaves) as the state dict of the
    port's ``models.lm.LM``, bit for bit: ``blocks.{layer}.<path>`` in
    layer order (prefix, then repeat r x pattern position i, then
    suffix), every other leaf under its own dotted path."""
    state = {}
    for layer, sub in _per_layer(params, cfg):
        for path, leaf in sub.items():
            state[f"blocks.{layer}.{path}"] = to_tensor(leaf, device)
    for key, sub in params.items():
        if key not in ("prefix", "blocks", "suffix"):
            for path, leaf in _flat(sub, f"{key}."):
                state[path] = to_tensor(leaf, device)
    return state


def opt_state_from_numpy(state, cfg, device="cuda") -> dict:
    """The JAX ``Optimizer.init``/``update`` state (numpy leaves) as the
    port's ``repro_torch.training.optimizer`` state: AdamW's ``m``, ``v``
    and ``master`` trees as the model's parameters
    (``lm_params_from_numpy``), Adafactor's ``v_row``/``v_col`` per JAX
    leaf under its dotted path, stacked as in JAX (the keys of
    ``repro_torch.models.lm.leaf_groups``)."""
    if "master" in state:
        return {k: lm_params_from_numpy(state[k], cfg, device)
                for k in ("m", "v", "master")}
    return {k: {path: to_tensor(leaf, device)
                for path, leaf in _flat(state[k])}
            for k in ("v_row", "v_col")}


def _nest(flat: dict) -> dict:
    """A {dotted path: leaf} dict as the nested dict it flattens."""
    out: dict = {}
    for path, leaf in flat.items():
        *parents, key = path.split(".")
        node = out
        for name in parents:
            node = node.setdefault(name, {})
        node[key] = leaf
    return out


def lm_cache_from_numpy(cache, cfg, device="cuda") -> list[dict]:
    """The JAX ``decode.init_cache``/``prefill`` cache tree (numpy
    leaves) as the port's per-layer cache list, each layer's dict nested
    as in the JAX tree (the SSD cache's ``conv`` holds ``x`` and ``bc``)."""
    out = [None] * cfg.n_layers
    for layer, sub in _per_layer(cache, cfg):
        out[layer] = _nest({k: to_tensor(v, device) for k, v in sub.items()})
    return out


def lm_cache_to_numpy(cache, cfg) -> dict:
    """The port's per-layer cache list as the JAX package's cache tree
    (``prefix`` / ``blocks/pos{i}`` stacked over repeats / ``suffix``)
    with numpy leaves."""
    def leaves(layer):
        return {k: to_numpy(v) for k, v in _flat(cache[layer])}

    tree = {"prefix": [_nest(leaves(_layer_index(cfg, "prefix", i)))
                       for i in range(len(cfg.prefix))],
            "suffix": [_nest(leaves(_layer_index(cfg, "suffix", i)))
                       for i in range(len(cfg.suffix))],
            "blocks": {}}
    for i in range(len(cfg.pattern)):
        per = [leaves(_layer_index(cfg, "blocks", i, r))
               for r in range(cfg.repeats)]
        tree["blocks"][f"pos{i}"] = _nest({k: np.stack([p[k] for p in per])
                                           for k in per[0]})
    return tree

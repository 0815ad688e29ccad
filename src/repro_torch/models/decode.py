"""Serving paths: cache init, prefill (cache building), single-token decode.

The port of ``repro.models.decode`` on one device. The cache is a list
with one dict per layer, in layer order:
  global, global_moe : dense KV cache (B, max_len, KV, hd) + slot positions
  local              : ring-buffer KV cache (B, window, KV, hd) + slots
  mla, mla_moe       : compressed latent cache {c_kv (B, max_len, kv_lora),
                       k_rope (B, max_len, rope)} bf16
  rec                : {conv (B, cw-1, W) bf16, h (B, W) float32}
  ssd                : {conv {x (B, cw-1, d_inner), bc (B, cw-1, 2N)} bf16,
                       h (B, H, P, N) float32}
(the JAX package's per-layer trees; ``repro_torch.interop`` carries them
across). A Python loop over the layers replaces the JAX package's
``lax.scan`` over stacked repeats. ``decode_step`` updates the cache in
place.

Inputs by family: token ids (B, S) — (B, 1) in decode; audio (musicgen)
token grids (B, S, K) — (B, 1, K) — whose K codebook embeddings are
summed, with logits (B, K, V) from one head per codebook; a VLM (llava)
takes precomputed patch embeddings ``patches`` (B, P, E) in prefill,
projected and placed before the text, so the text's first decode
position is P + S.

``kernel=`` (``repro_torch.kernels.dispatch``) picks the kernels' path:
under ``"auto"`` a CUDA model runs prefill through the ``flash_attention``,
``ssd_scan`` and ``rglru_scan`` kernels and decode through the
``decode_attention`` kernel (the recurrent layers' one-token updates are
plain PyTorch, as in the JAX package; MLA's attention is plain in both,
as the JAX package serves it; MoE's expert products are batched
matmuls); ``"off"`` runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, lm, mla, rglru, ssd
from repro_torch.models.layers import mlp, rmsnorm

Cache = list[dict]


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device) -> dict:
    mixer, _ = lm._mixer_mlp(kind)
    if mixer == "mla":
        return mla.init_mla_cache(batch, max_len, cfg.mla, device=device)
    if mixer == "rec":
        return rglru.init_rglru_cache(batch, cfg.d_model, cfg.rglru, device)
    if mixer == "ssd":
        return ssd.init_ssd_cache(batch, cfg.d_model, cfg.ssm, device)
    return attn.init_cache(batch, mixer, max_len, cfg.window, cfg.n_kv_heads,
                           cfg.head_dim, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Cache:
    """Empty caches of every layer on ``device``."""
    return [init_block_cache(cfg, kind, batch, max_len, device)
            for kind in cfg.layer_kinds]


def _theta(cfg: ModelConfig, mixer: str) -> float:
    if mixer == "local" and cfg.rope_local_theta:
        return cfg.rope_local_theta
    return cfg.rope_theta


def _attn_kw(cfg: ModelConfig, mixer: str, kernel: str) -> dict:
    return dict(kind=mixer, window=cfg.window, rope_theta=_theta(cfg, mixer),
                attn_softcap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
                eps=cfg.norm_eps, kernel=kernel)


def _mlp_residual(p: lm.Block, x: torch.Tensor, cfg: ModelConfig,
                  capacity: int | None = None) -> torch.Tensor:
    """The block's MLP (dense or MoE) and its residual; a kind without an
    MLP (``ssd``) passes ``x`` through. ``capacity``: the MoE's slots per
    expert (decode passes the batch size: no token is dropped)."""
    if p.mlp_kind == "none":
        return x
    h = rmsnorm(p.mlp_norm, x, cfg.norm_eps)
    if p.mlp_kind == "moe":
        h, _ = lm._run_moe(p.mlp, h, cfg, capacity=capacity)
    else:
        h = mlp(p.mlp, h, cfg.mlp_act)
    if cfg.post_norm:
        h = rmsnorm(p.post_mlp_norm, h, cfg.norm_eps)
    return x + h


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def block_decode(p: lm.Block, cache: dict,
                 x: torch.Tensor, cfg: ModelConfig, pos: int,
                 kernel: str) -> tuple[torch.Tensor, dict]:
    h = rmsnorm(p.pre_norm, x, cfg.norm_eps)
    if p.kind == "rec":
        h, cache = rglru.rglru_decode(p.mixer, h, cache, cfg.rglru)
    elif p.kind == "ssd":
        h, cache = ssd.ssd_decode(p.mixer, h, cache, cfg.ssm)
    elif p.kind == "mla":
        h, cache = mla.mla_decode(p.mixer, h, cache, pos, cfg=cfg.mla,
                                  rope_theta=cfg.rope_theta,
                                  eps=cfg.norm_eps)
    else:
        h, cache = attn.decode_attention(p.mixer, h, cache, pos,
                                         **_attn_kw(cfg, p.kind, kernel))
    if cfg.post_norm:
        h = rmsnorm(p.post_mixer_norm, h, cfg.norm_eps)
    return _mlp_residual(p, x + h, cfg, capacity=x.shape[0]), cache


def _embed_step(model: lm.LM, tokens: torch.Tensor,
                patches: torch.Tensor | None = None) -> torch.Tensor:
    """Model inputs -> scaled embeddings (B, S, D) in the table's dtype:
    token ids (B, S); audio grids (B, S, K), the K codebooks' embeddings
    added in order from zero; a VLM's ``patches`` (B, P, E) projected and
    placed before the text. The scale (gemma) applies to the whole
    sequence, as in the JAX package."""
    cfg = model.cfg
    if cfg.family == "audio":
        tables = model.embed.table                   # (K, V, D)
        x = torch.zeros((*tokens.shape[:2], cfg.d_model),
                        dtype=tables.dtype, device=tables.device)
        for k in range(cfg.n_codebooks):
            x = x + tables[k][tokens[..., k]]
    else:
        x = layers.embed(model.embed, tokens, False, cfg.d_model)
    if cfg.patch_stub is not None and patches is not None:
        x_patch = layers.linear(model.patch_proj, patches.to(x.dtype))
        x = torch.cat([x_patch, x], dim=1)
    elif patches is not None:
        raise ValueError(f"{cfg.name} takes no patch embeddings")
    if cfg.embed_scale:
        # the reference scales by sqrt(d) rounded to the compute dtype
        x = x * float(torch.tensor(cfg.d_model**0.5, dtype=x.dtype))
    return x


def _logits(model: lm.LM, x_last: torch.Tensor) -> torch.Tensor:
    """Final norm and head of the last position (B, D) -> (B, V), or (B,
    K, V) for audio: one head per codebook."""
    cfg = model.cfg
    h = rmsnorm(model.final_norm, x_last, cfg.norm_eps)
    table = lm._head_table(model)
    if cfg.family == "audio":
        logits = torch.stack(
            [layers.logits_from_hidden(table[k], h, cfg.final_softcap)
             for k in range(cfg.n_codebooks)], dim=1)
    else:
        logits = layers.logits_from_hidden(table, h, cfg.final_softcap)
    return logits[..., :cfg.vocab_size]  # drop the padding columns


@torch.no_grad()
def decode_step(model: lm.LM, cache: Cache, tokens: torch.Tensor, pos: int,
                *, kernel: str = "auto") -> tuple[torch.Tensor, Cache]:
    """One token for every sequence in the batch.

    tokens: (B, 1) int (audio: (B, 1, K)); pos: the tokens' position.
    Returns (logits (B, V) float32 — audio (B, K, V) —, the cache,
    updated in place)."""
    cfg = model.cfg
    x = _embed_step(model, tokens)
    for p, c in zip(model.blocks, cache):
        x, _ = block_decode(p, c, x, cfg, pos, kernel)
    return _logits(model, x[:, 0]), cache


# ---------------------------------------------------------------------------
# Prefill: full-sequence pass that also builds the cache
# ---------------------------------------------------------------------------


def _attn_cache_from_kv(k: torch.Tensor, v: torch.Tensor, mixer: str,
                        window: int, max_len: int) -> dict[str, torch.Tensor]:
    b, s = k.shape[:2]
    dev = k.device
    length = window if mixer == "local" else max_len
    if mixer != "local" and s > max_len:
        raise ValueError(f"prompt of {s} tokens is longer than "
                         f"max_len={max_len}")
    n = min(s, length)
    slots = torch.arange(s - n, s, device=dev) % length
    ck = torch.zeros((b, length, *k.shape[2:]), dtype=k.dtype, device=dev)
    cv = torch.zeros((b, length, *v.shape[2:]), dtype=v.dtype, device=dev)
    ck[:, slots] = k[:, s - n:]
    cv[:, slots] = v[:, s - n:]
    pos = torch.full((length,), -1, dtype=torch.int32, device=dev)
    pos[slots] = torch.arange(s - n, s, dtype=torch.int32, device=dev)
    return {"k": ck, "v": cv, "pos": pos}


def block_prefill(p: lm.Block, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, max_len: int,
                  kernel: str) -> tuple[torch.Tensor, dict]:
    h = rmsnorm(p.pre_norm, x, cfg.norm_eps)
    if p.kind == "rec":
        h, cache = rglru.rglru_block(p.mixer, h, cfg.rglru, kernel=kernel,
                                     return_state=True)
    elif p.kind == "ssd":
        h, cache = ssd.ssd_block(p.mixer, h, cfg.ssm, kernel=kernel,
                                 return_state=True)
    elif p.kind == "mla":
        h, (c_kv, k_rope) = mla.mla_attention(
            p.mixer, h, positions, cfg=cfg.mla, rope_theta=cfg.rope_theta,
            eps=cfg.norm_eps, return_kv=True)
        cache = mla.mla_cache_from_latents(c_kv, k_rope, max_len)
    else:
        h, (k, v) = attn.attention(p.mixer, h, positions, return_kv=True,
                                   **_attn_kw(cfg, p.kind, kernel))
        cache = _attn_cache_from_kv(k, v, p.kind, cfg.window, max_len)
    if cfg.post_norm:
        h = rmsnorm(p.post_mixer_norm, h, cfg.norm_eps)
    return _mlp_residual(p, x + h, cfg), cache


@torch.no_grad()
def prefill(model: lm.LM, tokens: torch.Tensor, max_len: int, *,
            patches: torch.Tensor | None = None,
            kernel: str = "auto") -> tuple[torch.Tensor, Cache]:
    """Run the prompt ``tokens`` (B, S) — audio (B, S, K) — and, for a VLM,
    its ``patches`` (B, P, E) before it; build the cache. Returns
    (last-position logits (B, V) float32 — audio (B, K, V) —, cache)."""
    cfg = model.cfg
    if cfg.patch_stub is not None and patches is None:
        raise ValueError(f"{cfg.name} takes patch embeddings (patches=) "
                         f"before the text")
    x = _embed_step(model, tokens, patches)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    cache = []
    for p in model.blocks:
        x, c = block_prefill(p, x, cfg, positions, max_len, kernel)
        cache.append(c)
    return _logits(model, x[:, -1]), cache

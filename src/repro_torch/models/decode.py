"""Serving paths: cache init, prefill (cache building), single-token decode.

The port of ``repro.models.decode`` for attention models on one device.
The cache is a list with one dict per layer, in layer order:
  global : dense KV cache (B, max_len, KV, hd) + slot positions (max_len,)
  local  : ring-buffer KV cache (B, window, KV, hd) + slot positions
A Python loop over the layers replaces the JAX package's ``lax.scan``
over stacked repeats. ``decode_step`` updates the cache in place.

``kernel=`` (``repro_torch.kernels.dispatch``) picks the attention path:
under ``"auto"`` a CUDA model runs prefill through the ``flash_attention``
kernel and decode through the ``decode_attention`` kernel; ``"off"``
runs their plain PyTorch versions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, lm
from repro_torch.models.layers import mlp, rmsnorm

Cache = list[dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Cache:
    """Empty caches of every layer on ``device``."""
    out = []
    for kind in cfg.layer_kinds:
        mixer, _ = lm._mixer_mlp(kind)
        out.append(attn.init_cache(batch, mixer, max_len, cfg.window,
                                   cfg.n_kv_heads, cfg.head_dim,
                                   device=device))
    return out


def _theta(cfg: ModelConfig, mixer: str) -> float:
    if mixer == "local" and cfg.rope_local_theta:
        return cfg.rope_local_theta
    return cfg.rope_theta


def _attn_kw(cfg: ModelConfig, mixer: str, kernel: str) -> dict:
    return dict(kind=mixer, window=cfg.window, rope_theta=_theta(cfg, mixer),
                attn_softcap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
                eps=cfg.norm_eps, kernel=kernel)


def _mlp_residual(p: lm.Block, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(p.mlp_norm, x, cfg.norm_eps)
    h = mlp(p.mlp, h, cfg.mlp_act)
    if cfg.post_norm:
        h = rmsnorm(p.post_mlp_norm, h, cfg.norm_eps)
    return x + h


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def block_decode(p: lm.Block, cache: dict[str, torch.Tensor],
                 x: torch.Tensor, cfg: ModelConfig, pos: int,
                 kernel: str) -> tuple[torch.Tensor, dict]:
    h = rmsnorm(p.pre_norm, x, cfg.norm_eps)
    h, cache = attn.decode_attention(p.mixer, h, cache, pos,
                                     **_attn_kw(cfg, p.kind, kernel))
    if cfg.post_norm:
        h = rmsnorm(p.post_mixer_norm, h, cfg.norm_eps)
    return _mlp_residual(p, x + h, cfg), cache


def _embed_step(model: lm.LM, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> scaled bf16 embeddings (B, S, D)."""
    cfg = model.cfg
    return layers.embed(model.embed, tokens, cfg.embed_scale, cfg.d_model)


def _logits(model: lm.LM, x_last: torch.Tensor) -> torch.Tensor:
    """Final norm and tied head of the last position (B, D) -> (B, V)."""
    cfg = model.cfg
    h = rmsnorm(model.final_norm, x_last, cfg.norm_eps)
    logits = layers.logits_from_hidden(lm._head_table(model), h,
                                       cfg.final_softcap)
    return logits[..., :cfg.vocab_size]  # drop the padding columns


@torch.no_grad()
def decode_step(model: lm.LM, cache: Cache, tokens: torch.Tensor, pos: int,
                *, kernel: str = "auto") -> tuple[torch.Tensor, Cache]:
    """One token for every sequence in the batch.

    tokens: (B, 1) int; pos: the tokens' position. Returns (logits (B, V)
    float32, the cache, updated in place)."""
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
    h, (k, v) = attn.attention(p.mixer, h, positions, return_kv=True,
                               **_attn_kw(cfg, p.kind, kernel))
    cache = _attn_cache_from_kv(k, v, p.kind, cfg.window, max_len)
    if cfg.post_norm:
        h = rmsnorm(p.post_mixer_norm, h, cfg.norm_eps)
    return _mlp_residual(p, x + h, cfg), cache


@torch.no_grad()
def prefill(model: lm.LM, tokens: torch.Tensor, max_len: int, *,
            kernel: str = "auto") -> tuple[torch.Tensor, Cache]:
    """Run the prompt ``tokens`` (B, S), build the cache. Returns
    (last-position logits (B, V) float32, cache)."""
    cfg = model.cfg
    x = _embed_step(model, tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    cache = []
    for p in model.blocks:
        x, c = block_prefill(p, x, cfg, positions, max_len, kernel)
        cache.append(c)
    return _logits(model, x[:, -1]), cache

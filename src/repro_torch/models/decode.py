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

Sharded serving (``ctx=``, ROADMAP queue 1 item 14f) under the layouts
of ``repro_torch.distributed.sharding.make_layout``. ``prefill`` takes
this rank's rows of the batch (``ctx.batch``), runs its block of the
embedded sequence (``ctx.seq``: patches and text together) on a
``ShardedModel`` whose parts are gathered at their use (the training
rules, as the JAX package's prefill reads them), and returns the last
position's logits of its rows on every rank and its block of the cache
under the DECODE layout of the same batch. ``decode_step`` takes that
block and this rank's rows on a ``ShardedModel`` in the inference rules'
blocks read in place (``ShardedModel.reshard(ctx, inference=True)``):
attention over a KV cache split over ``ctx.kv_seq`` combines the ranks'
partial softmaxes; recurrent states are gathered whole for the step.
With ``ctx=None`` both are the one-device path.

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
from repro_torch.distributed import collectives, sharding, tp
from repro_torch.distributed.ctx import (ShardCtx, batch_axes, check_seq,
                                        seq_axes)
from repro_torch.models import attention as attn
from repro_torch.models import layers, lm, mla, rglru, ssd
from repro_torch.models.layers import rmsnorm

Cache = list[dict]

# the parts of a model that serving reads outside the block stack
SERVE_PARTS = ("embed", "patch_proj", "final_norm", "lm_head")


def _serving(model) -> tuple[lm.LM, object]:
    """(the ``LM`` the stack runs, its ``use`` or None): a
    ``ShardedModel`` gives its placeholder model and its ``use``."""
    if isinstance(model, sharding.ShardedModel):
        return model.model, model.use
    return model, None


def _batch_shards(ctx: ShardCtx | None) -> int:
    return tp.axes_size(ctx.mesh, batch_axes(ctx)) if ctx is not None else 1


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


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def block_decode(p: lm.Block, cache: dict,
                 x: torch.Tensor, cfg: ModelConfig, pos: int,
                 kernel: str, ctx: ShardCtx | None = None
                 ) -> tuple[torch.Tensor, dict]:
    h = rmsnorm(p.pre_norm, x, cfg.norm_eps)
    if p.kind == "rec":
        h, cache = rglru.rglru_decode(p.mixer, h, cache, cfg.rglru, ctx)
    elif p.kind == "ssd":
        h, cache = ssd.ssd_decode(p.mixer, h, cache, cfg.ssm, ctx)
    elif p.kind == "mla":
        h, cache = mla.mla_decode(p.mixer, h, cache, pos, cfg=cfg.mla,
                                  rope_theta=cfg.rope_theta,
                                  eps=cfg.norm_eps, ctx=ctx)
    else:
        h, cache = attn.decode_attention(p.mixer, h, cache, pos, ctx=ctx,
                                         **lm._attn_kw(cfg, p.kind, kernel))
    if cfg.post_norm:
        h = rmsnorm(p.post_mixer_norm, h, cfg.norm_eps)
    # the capacity is the global batch: no decode token is dropped
    return lm._mlp_residual(p, x + h, cfg,
                            capacity=x.shape[0] * _batch_shards(ctx),
                            ctx=ctx)[0], cache


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
def decode_step(model, cache: Cache, tokens: torch.Tensor, pos: int,
                *, kernel: str = "auto", ctx: ShardCtx | None = None
                ) -> tuple[torch.Tensor, Cache]:
    """One token for every sequence in the batch.

    tokens: (B, 1) int (audio: (B, 1, K)); pos: the tokens' position.
    Returns (logits (B, V) float32 — audio (B, K, V) —, the cache,
    updated in place). Under a ctx (module docstring) ``model`` is an
    ``LM`` or a ``ShardedModel``, ``tokens`` and ``cache`` this rank's
    rows and blocks; the logits are those of its rows."""
    model, use = _serving(model)
    cfg = model.cfg
    with lm._using(use, SERVE_PARTS):
        x = lm.embed(model, tokens)
        for i, (p, c) in enumerate(zip(model.blocks, cache)):
            with lm._using(use, [f"blocks.{i}"]):
                x, _ = block_decode(p, c, x, cfg, pos, kernel, ctx)
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
                  kernel: str, ctx: ShardCtx | None = None
                  ) -> tuple[torch.Tensor, dict]:
    h = rmsnorm(p.pre_norm, x, cfg.norm_eps)
    check_seq(ctx, p.kind)
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
                                   ctx=ctx,
                                   **lm._attn_kw(cfg, p.kind, kernel))
        cache = _attn_cache_from_kv(k, v, p.kind, cfg.window, max_len)
    if cfg.post_norm:
        h = rmsnorm(p.post_mixer_norm, h, cfg.norm_eps)
    return lm._mlp_residual(p, x + h, cfg, ctx=ctx)[0], cache


@torch.no_grad()
def prefill(model, tokens: torch.Tensor, max_len: int, *,
            patches: torch.Tensor | None = None,
            kernel: str = "auto", ctx: ShardCtx | None = None
            ) -> tuple[torch.Tensor, Cache]:
    """Run the prompt ``tokens`` (B, S) — audio (B, S, K) — and, for a VLM,
    its ``patches`` (B, P, E) before it; build the cache. Returns
    (last-position logits (B, V) float32 — audio (B, K, V) —, cache).
    Under a ctx (module docstring) ``model`` is an ``LM`` or a
    ``ShardedModel``, ``tokens`` and ``patches`` this rank's rows of the
    whole prompt; the cache is this rank's block under the decode layout
    (``decode_cache``)."""
    model, use = _serving(model)
    cfg = model.cfg
    if cfg.patch_stub is not None and patches is None:
        raise ValueError(f"{cfg.name} takes patch embeddings (patches=) "
                         f"before the text")
    with lm._using(use, SERVE_PARTS):
        x = lm.embed(model, tokens, patches)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        # this rank's block of the (patches + text) sequence
        x, positions = lm.seq_block(ctx, x, positions)
        x = x.contiguous()
        cache = []
        for i, p in enumerate(model.blocks):
            with lm._using(use, [f"blocks.{i}"]):
                x, c = block_prefill(p, x, cfg, positions, max_len, kernel,
                                     ctx)
            cache.append(c)
        x_last = x[:, -1]
        axes = seq_axes(ctx)
        if axes:  # the last position is the last rank's
            x_last = collectives.broadcast(x_last, ctx.mesh, axes,
                                           tp.axes_size(ctx.mesh, axes) - 1)
        logits = _logits(model, x_last)
    if ctx is not None:
        cache = decode_cache(cfg, ctx, cache, b * _batch_shards(ctx))
    return logits, cache


def decode_cache(cfg: ModelConfig, ctx: ShardCtx, cache: Cache,
                 batch: int) -> Cache:
    """A prefill's cache of this rank's rows (over ``ctx.batch``; whole
    along the sequence) -> its block under the decode layout of the same
    global ``batch`` (``make_layout(cfg, "decode", ...)``: the KV slots
    over ``kv_seq``, recurrent states over ``model``), for
    ``decode_step`` under that layout's ctx."""
    def whole(tree: dict) -> dict:  # the global shapes, which specs read
        return {k: whole(v) if isinstance(v, dict) else
                v if k == "pos" else
                torch.empty((batch, *v.shape[1:]), device="meta")
                for k, v in tree.items()}

    like = [whole(layer) for layer in cache]
    layout = sharding.make_layout(
        cfg, "decode", "pod" in collectives.mesh_sizes(ctx.mesh), batch)
    specs = sharding.cache_specs(cfg, ctx.mesh, layout, like)
    return sharding.cache_blocks(cache, specs, ctx.mesh, batch_axes(ctx))

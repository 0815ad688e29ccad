"""The LM assembler, serving subset: the block stack and its init.

The port of ``repro.models.lm`` for the kinds the port can serve. A model
is a stack of residual blocks described by ``cfg.layer_kinds``:
    kind          mixer               mlp
    "global"      full GQA attention  dense
    "local"       windowed GQA        dense
The other kinds of the JAX package (MLA, MoE, RG-LRU, SSD) raise
``NotImplementedError`` until their slices port them; training
(``forward_hidden``, ``loss_fn``) waits too.

``LM`` is an ``nn.Module``: the embedding, a ``ModuleList`` of blocks in
layer order (``cfg.prefix``, then ``cfg.pattern`` x ``cfg.repeats``, then
``cfg.suffix`` — the JAX package stacks the repeated part along a leading
axis and scans it; the port runs a Python loop), the final norm and the
head, tied to the embedding. Prefill and decode are plain functions over
it (``repro_torch.models.decode``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers

KIND_TABLE = {
    "global": ("global", "dense"),
    "local": ("local", "dense"),
    "global_moe": ("global", "moe"),
    "mla": ("mla", "dense"),
    "mla_moe": ("mla", "moe"),
    "rec": ("rec", "dense"),
    "ssd": ("ssd", "none"),
}

# Mixers and MLPs of the JAX package that the port does not run yet, with
# the ROADMAP item that ports each.
_REST = "ROADMAP queue 1 item 14 (the rest of the LM substrate)"
NOT_PORTED = {
    "ssd": "ROADMAP queue 1 item 8 (mamba2-370m serving, ssd_scan)",
    "rec": "ROADMAP queue 1 item 9 (recurrentgemma-9b serving, rglru_scan)",
    "mla": _REST,
    "moe": _REST,
}


def _mixer_mlp(kind: str) -> tuple[str, str]:
    mixer, mlp_kind = KIND_TABLE[kind]
    for part in (mixer, mlp_kind):
        if part in NOT_PORTED:
            raise NotImplementedError(
                f"layer kind {kind!r} needs {part!r}, which the port does "
                f"not run yet: {NOT_PORTED[part]}")
    return mixer, mlp_kind


class Block(nn.Module):
    """One residual block: ``pre_norm``, ``mixer``, ``mlp_norm``, ``mlp``
    and, with ``cfg.post_norm``, ``post_mixer_norm``/``post_mlp_norm``."""

    def __init__(self, kind: str, pre_norm, mixer, mlp_norm, mlp,
                 post_mixer_norm=None, post_mlp_norm=None):
        super().__init__()
        self.kind = kind
        self.pre_norm, self.mixer = pre_norm, mixer
        self.mlp_norm, self.mlp = mlp_norm, mlp
        if post_mixer_norm is not None:
            self.post_mixer_norm = post_mixer_norm
            self.post_mlp_norm = post_mlp_norm


class LM(nn.Module):
    """``embed``, ``blocks`` (layer order) and ``final_norm``; the output
    head is the embedding table (``_head_table``)."""

    def __init__(self, cfg: ModelConfig, embed: layers.Embedding,
                 blocks: list[Block], final_norm: layers.RMSNorm):
        super().__init__()
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: an untied output head is not ported yet "
                f"({_REST})")
        self.cfg = cfg
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm


def init_block(generator: torch.Generator, cfg: ModelConfig,
               kind: str) -> Block:
    mixer, _ = _mixer_mlp(kind)
    dev = generator.device
    mix = attn.init_attention(generator, cfg.d_model, cfg.n_heads,
                              cfg.n_kv_heads, cfg.head_dim, cfg.use_bias,
                              cfg.qk_norm)
    mlp = layers.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                          cfg.use_bias)
    post = ((layers.RMSNorm(cfg.d_model, dev),
             layers.RMSNorm(cfg.d_model, dev))
            if cfg.post_norm else (None, None))
    return Block(mixer, layers.RMSNorm(cfg.d_model, dev), mix,
                 layers.RMSNorm(cfg.d_model, dev), mlp, *post)


def init(generator: torch.Generator, cfg: ModelConfig) -> LM:
    """A model with random weights drawn from ``generator``, on its
    device, from the JAX package's distributions (not its bits)."""
    if cfg.family not in ("dense", "hybrid") or cfg.patch_stub is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"({_REST})")
    with torch.no_grad():
        embed = layers.init_embedding(generator, cfg.vocab_padded,
                                      cfg.d_model)
        blocks = [init_block(generator, cfg, kind)
                  for kind in cfg.layer_kinds]
        final_norm = layers.RMSNorm(cfg.d_model, generator.device)
    return LM(cfg, embed, blocks, final_norm)


def _head_table(model: LM) -> torch.Tensor:
    """(V, D) table used for output logits (tied to the embedding)."""
    return model.embed.table

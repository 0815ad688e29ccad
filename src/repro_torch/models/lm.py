"""The LM assembler, serving side: the block stack and its init.

The port of ``repro.models.lm`` for every architecture the JAX package
registers. A model is a stack of residual blocks described by
``cfg.layer_kinds``:
    kind          mixer               mlp
    "global"      full GQA attention  dense
    "local"       windowed GQA        dense
    "global_moe"  full GQA            mixture-of-experts
    "mla"         DeepSeek MLA        dense
    "mla_moe"     DeepSeek MLA        mixture-of-experts
    "rec"         RG-LRU recurrence   dense
    "ssd"         Mamba-2 SSD         (none)
Training (``forward_hidden``, ``loss_fn``, the MTP loss) is not ported
yet (ROADMAP queue 1 item 14d), nor expert parallelism under a mesh
(14e): ``_run_moe`` is the JAX package's one-device path.

``LM`` is an ``nn.Module``: the embedding (``(K, V, D)``, one table per
codebook, for audio), a ``ModuleList`` of blocks in layer order
(``cfg.prefix``, then ``cfg.pattern`` x ``cfg.repeats``, then
``cfg.suffix`` — the JAX package stacks the repeated part along a leading
axis and scans it; the port runs a Python loop), the final norm, the
untied head ``lm_head`` where the config has one (``(D, V)``, or ``(K,
D, V)`` for audio, as JAX stores it), the patch projector ``patch_proj``
of a VLM and the MTP block of deepseek (built so that the parameters
carry across; serving does not read it). Prefill and decode are plain
functions over it (``repro_torch.models.decode``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, mla, moe, rglru, ssd

KIND_TABLE = {
    "global": ("global", "dense"),
    "local": ("local", "dense"),
    "global_moe": ("global", "moe"),
    "mla": ("mla", "dense"),
    "mla_moe": ("mla", "moe"),
    "rec": ("rec", "dense"),
    "ssd": ("ssd", "none"),
}


def _mixer_mlp(kind: str) -> tuple[str, str]:
    return KIND_TABLE[kind]


class Block(nn.Module):
    """One residual block: ``pre_norm``, ``mixer`` and, where the kind has
    an MLP, ``mlp_norm``/``mlp`` (dense or MoE: ``mlp_kind``); with
    ``cfg.post_norm`` also ``post_mixer_norm`` (and ``post_mlp_norm`` with
    an MLP) — the JAX tree's keys. ``kind`` is the mixer."""

    def __init__(self, kind: str, pre_norm, mixer, mlp_norm=None, mlp=None,
                 post_mixer_norm=None, post_mlp_norm=None,
                 mlp_kind: str = "dense"):
        super().__init__()
        self.kind = kind
        self.mlp_kind = mlp_kind if mlp is not None else "none"
        self.pre_norm, self.mixer = pre_norm, mixer
        if mlp is not None:
            self.mlp_norm, self.mlp = mlp_norm, mlp
        if post_mixer_norm is not None:
            self.post_mixer_norm = post_mixer_norm
        if post_mlp_norm is not None:
            self.post_mlp_norm = post_mlp_norm


class MTP(nn.Module):
    """DeepSeek's depth-1 multi-token-prediction block: ``proj`` (2D, D),
    ``h_norm``, ``e_norm`` and a ``block`` of the model's mixer kind."""

    def __init__(self, proj, h_norm, e_norm, block: Block):
        super().__init__()
        self.proj, self.h_norm, self.e_norm = proj, h_norm, e_norm
        self.block = block


class LM(nn.Module):
    """``embed``, ``blocks`` (layer order), ``final_norm`` and, where the
    config has them, ``lm_head``, ``patch_proj`` and ``mtp``; the output
    head is ``_head_table``."""

    def __init__(self, cfg: ModelConfig, embed: layers.Embedding,
                 blocks: list[Block], final_norm: layers.RMSNorm,
                 lm_head: layers.Linear | None = None,
                 patch_proj: layers.Linear | None = None,
                 mtp: MTP | None = None):
        super().__init__()
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: tie_embeddings="
                             f"{cfg.tie_embeddings} but lm_head is "
                             f"{'absent' if lm_head is None else 'given'}")
        self.cfg = cfg
        self.embed = embed
        if patch_proj is not None:
            self.patch_proj = patch_proj
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        if lm_head is not None:
            self.lm_head = lm_head
        if mtp is not None:
            self.mtp = mtp


def init_block(generator: torch.Generator, cfg: ModelConfig,
               kind: str) -> Block:
    mixer, mlp_kind = _mixer_mlp(kind)
    dev = generator.device
    if mixer in ("global", "local"):
        mix = attn.init_attention(generator, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.head_dim, cfg.use_bias,
                                  cfg.qk_norm)
    elif mixer == "mla":
        mix = mla.init_mla(generator, cfg.d_model, cfg.n_heads, cfg.mla)
    elif mixer == "rec":
        mix = rglru.init_rglru_block(generator, cfg.d_model, cfg.rglru)
    else:  # "ssd"
        mix = ssd.init_ssd_block(generator, cfg.d_model, cfg.ssm)

    def norm():
        return layers.RMSNorm(cfg.d_model, dev)

    post_mixer = norm() if cfg.post_norm else None
    if mlp_kind == "none":
        return Block(mixer, norm(), mix, post_mixer_norm=post_mixer)
    if mlp_kind == "moe":
        mlp = moe.init_moe(generator, cfg.d_model, cfg.moe, cfg.gated_mlp)
    else:
        mlp = layers.init_mlp(generator, cfg.d_model, cfg.d_ff,
                              cfg.gated_mlp, cfg.use_bias)
    return Block(mixer, norm(), mix, norm(), mlp, post_mixer,
                 norm() if cfg.post_norm else None, mlp_kind)


def init(generator: torch.Generator, cfg: ModelConfig) -> LM:
    """A model with random weights drawn from ``generator``, on its
    device, from the JAX package's distributions (not its bits)."""
    dev = generator.device
    vocab = cfg.vocab_padded
    audio = cfg.family == "audio"
    with torch.no_grad():
        embed = layers.init_embedding(generator, vocab, cfg.d_model,
                                      n_tables=cfg.n_codebooks if audio
                                      else 0)
        patch_proj = (layers.init_linear(generator, cfg.patch_stub.embed_dim,
                                         cfg.d_model)
                      if cfg.patch_stub is not None else None)
        blocks = [init_block(generator, cfg, kind)
                  for kind in cfg.layer_kinds]
        final_norm = layers.RMSNorm(cfg.d_model, dev)
        lm_head = None
        if not cfg.tie_embeddings:
            shape = ((cfg.n_codebooks, cfg.d_model, vocab) if audio
                     else (cfg.d_model, vocab))
            lm_head = layers.Linear(shape, device=dev)
            for w in (lm_head.w if audio else [lm_head.w]):
                w.copy_(layers.truncated_normal(
                    (cfg.d_model, vocab), cfg.d_model**-0.5, generator))
        mtp = None
        if cfg.mtp:
            mtp = MTP(layers.init_linear(generator, 2 * cfg.d_model,
                                         cfg.d_model),
                      layers.RMSNorm(cfg.d_model, dev),
                      layers.RMSNorm(cfg.d_model, dev),
                      init_block(generator, cfg,
                                 "mla" if cfg.mla else "global"))
    return LM(cfg, embed, blocks, final_norm, lm_head, patch_proj, mtp)


def _head_table(model: LM) -> torch.Tensor:
    """(V, D) table used for output logits, or (K, V, D) for audio: the
    embedding where the head is tied, else a transposed view of
    ``lm_head.w`` (stored (D, V) / (K, D, V), as in JAX; no copy)."""
    if model.cfg.tie_embeddings:
        return model.embed.table
    return model.lm_head.w.transpose(-1, -2)


def _run_moe(p: moe.MoE, x: torch.Tensor, cfg: ModelConfig,
             capacity: int | None = None) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The MoE layer on one device: ``moe_mlp`` over every expert (the
    JAX package's path without a mesh; expert parallelism is 14e)."""
    return moe.moe_mlp(p, x, cfg.moe, cfg.mlp_act, capacity=capacity)


def counted_params(model: LM) -> int:
    """The weights that ``cfg.param_count`` counts: every parameter but
    the norm scales, the biases, the MTP block, the padded vocabulary
    rows (embedding and untied head) and the padded experts (their expert
    weights and router columns). Equal to ``param_count`` for every
    registered config."""
    cfg = model.cfg
    n = sum(p.numel() for name, p in model.named_parameters()
            if not name.endswith((".scale", ".b"))
            and not name.startswith("mtp."))
    n -= ((cfg.vocab_padded - cfg.vocab_size) * cfg.d_model
          * cfg.n_codebooks * (1 if cfg.tie_embeddings else 2))
    if cfg.moe is not None:
        per = cfg.d_model * cfg.moe.d_expert * (3 if cfg.gated_mlp else 2)
        n_moe = sum(_mixer_mlp(k)[1] == "moe" for k in cfg.layer_kinds)
        n -= n_moe * (cfg.moe.padded_experts - cfg.moe.n_experts) * (
            per + cfg.d_model)
    return n

"""The LM assembler: init, the block stack, the training loss.

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
Expert parallelism under a mesh is not ported (ROADMAP queue 1 item
14e): ``_run_moe`` is the JAX package's one-device path.

``LM`` is an ``nn.Module``: the embedding (``(K, V, D)``, one table per
codebook, for audio), a ``ModuleList`` of blocks in layer order
(``cfg.prefix``, then ``cfg.pattern`` x ``cfg.repeats``, then
``cfg.suffix`` — the JAX package stacks the repeated part along a leading
axis and scans it; the port runs a Python loop), the final norm, the
untied head ``lm_head`` where the config has one (``(D, V)``, or ``(K,
D, V)`` for audio, as JAX stores it), the patch projector ``patch_proj``
of a VLM and the MTP block of deepseek (read by the training loss
only). Prefill and decode are plain functions over it
(``repro_torch.models.decode``); ``loss_fn`` is the training loss over
``forward_hidden``, the block stack without a cache.

Training runs the kernels' plain versions (``kernel="off"``, the
counterpart of the JAX package's ``impl="ref"``): the CUDA kernels have
no backward pass, as no Pallas kernel of the JAX package has a VJP, and
``kernels.dispatch`` refuses to launch one on an input that requires
grad. ``loss_fn(..., kernel="auto")`` under ``torch.no_grad()`` (an
evaluation loss) launches them.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt_utils

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, mla, moe, rglru, ssd
from repro_torch.models.layers import mlp, rmsnorm

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


def leaf_groups(model: LM) -> dict[str, str | list[str]]:
    """The JAX tree's leaves as the port's parameter names: each JAX
    leaf's dotted path (list entries by index: ``prefix.0.pre_norm.scale``)
    maps to the one parameter that holds it, or, for a leaf of the
    repeated part (``blocks.pos{i}.<path>``, stacked along a leading
    repeats axis in JAX), to the list of the parameters that stack into
    it, in repeat order. ``repro_torch.interop.lm_params_from_numpy``
    takes the same map the other way."""
    cfg = model.cfg
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    n_rep = n_pre + cfg.repeats * n_pat
    groups: dict[str, str | list[str]] = {}
    for name, _ in model.named_parameters():
        if not name.startswith("blocks."):
            groups[name] = name
            continue
        _, layer, path = name.split(".", 2)
        layer = int(layer)
        if layer < n_pre:
            groups[f"prefix.{layer}.{path}"] = name
        elif layer < n_rep:
            i = (layer - n_pre) % n_pat
            groups.setdefault(f"blocks.pos{i}.{path}", []).append(name)
        else:
            groups[f"suffix.{layer - n_rep}.{path}"] = name
    return groups


# ---------------------------------------------------------------------------
# The block stack without a cache (training and evaluation losses)
# ---------------------------------------------------------------------------


def _theta(cfg: ModelConfig, mixer: str) -> float:
    if mixer == "local" and cfg.rope_local_theta:
        return cfg.rope_local_theta
    return cfg.rope_theta


def _attn_kw(cfg: ModelConfig, mixer: str, kernel: str) -> dict:
    return dict(kind=mixer, window=cfg.window, rope_theta=_theta(cfg, mixer),
                attn_softcap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
                eps=cfg.norm_eps, kernel=kernel)


def _mlp_residual(p: Block, x: torch.Tensor, cfg: ModelConfig,
                  capacity: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's MLP (dense or MoE) and its residual; a kind without an
    MLP (``ssd``) passes ``x`` through. ``capacity``: the MoE's slots per
    expert (decode passes the batch size: no token is dropped). Returns
    (x, the MoE's aux loss, or None for a dense or no MLP)."""
    if p.mlp_kind == "none":
        return x, None
    aux = None
    h = rmsnorm(p.mlp_norm, x, cfg.norm_eps)
    if p.mlp_kind == "moe":
        h, aux = _run_moe(p.mlp, h, cfg, capacity=capacity)
    else:
        h = mlp(p.mlp, h, cfg.mlp_act)
    if cfg.post_norm:
        h = rmsnorm(p.post_mlp_norm, h, cfg.norm_eps)
    return x + h, aux


def block_forward(p: Block, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, kernel: str
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One residual block over a full sequence, no cache. Returns (x,
    aux loss or None)."""
    h = rmsnorm(p.pre_norm, x, cfg.norm_eps)
    if p.kind == "rec":
        h = rglru.rglru_block(p.mixer, h, cfg.rglru, kernel=kernel)
    elif p.kind == "ssd":
        h = ssd.ssd_block(p.mixer, h, cfg.ssm, kernel=kernel)
    elif p.kind == "mla":
        h = mla.mla_attention(p.mixer, h, positions, cfg=cfg.mla,
                              rope_theta=cfg.rope_theta, eps=cfg.norm_eps)
    else:
        h = attn.attention(p.mixer, h, positions,
                           **_attn_kw(cfg, p.kind, kernel))
    if cfg.post_norm:
        h = rmsnorm(p.post_mixer_norm, h, cfg.norm_eps)
    return _mlp_residual(p, x + h, cfg)


def forward_hidden(model: LM, x: torch.Tensor, positions: torch.Tensor, *,
                   kernel: str = "off") -> tuple[torch.Tensor, torch.Tensor]:
    """Embedded inputs (B, S, D) -> final hidden states, no cache.
    Returns (h, aux loss float32). With ``cfg.remat`` and grad enabled,
    each repeat of ``cfg.pattern`` is recomputed in backward
    (``torch.utils.checkpoint``), as ``jax.checkpoint`` does over the JAX
    package's scanned superblocks under ``remat_policy="full"`` (the
    policy of every config; ``"dots"`` raises); ``cfg.prefix``/``suffix``
    are not."""
    cfg = model.cfg
    blocks = list(model.blocks)
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    n_rep = n_pre + cfg.repeats * n_pat
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(h, group):
        aux_sb = None
        for p in group:
            h, aux = block_forward(p, h, cfg, positions, kernel)
            if aux is not None:
                aux_sb = aux if aux_sb is None else aux_sb + aux
        return h, aux_sb

    run = body
    if cfg.remat and torch.is_grad_enabled():
        if cfg.remat_policy != "full":  # no config uses "dots"
            raise ValueError(f"remat_policy {cfg.remat_policy!r}: the port "
                             f"recomputes whole repeats only ('full')")
        run = functools.partial(ckpt_utils.checkpoint, body,
                                use_reentrant=False, preserve_rng_state=False)
    groups = ([blocks[i:i + 1] for i in range(n_pre)]
              + [blocks[i:i + n_pat] for i in range(n_pre, n_rep, n_pat)]
              + [blocks[i:i + 1] for i in range(n_rep, len(blocks))])
    for gi, group in enumerate(groups):
        repeat = n_pre <= gi < n_pre + cfg.repeats
        x, aux = (run if repeat else body)(x, group)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def embed(model: LM, tokens: torch.Tensor,
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


def embed_inputs(model: LM, batch: dict[str, torch.Tensor]):
    """A training batch -> (x (B, S, D), positions (B, S), targets,
    loss mask float32). ``batch["tokens"]`` is (B, S+1) — audio (B, S+1,
    K) —; a VLM's ``batch["patches"]`` (B, P, E) come first, their
    positions masked out of the loss."""
    cfg = model.cfg
    toks = batch["tokens"]
    inp, tgt = toks[:, :-1], toks[:, 1:]
    patches = batch.get("patches") if cfg.patch_stub is not None else None
    if cfg.patch_stub is not None and patches is None:
        raise ValueError(f"{cfg.name} takes patch embeddings before the "
                         f"text (batch['patches'])")
    x = embed(model, inp, patches)
    b, s = x.shape[:2]
    mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    if patches is not None:
        n_p = patches.shape[1]
        tgt = torch.cat([torch.zeros((b, n_p), dtype=tgt.dtype,
                                     device=tgt.device), tgt], dim=1)
        mask[:, :n_p] = 0.0
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions, tgt, mask


def loss_fn(model: LM, batch: dict[str, torch.Tensor], *,
            kernel: str = "off") -> tuple[torch.Tensor,
                                          dict[str, torch.Tensor]]:
    """The training loss: next-token cross entropy (audio: the mean over
    the K codebooks' full logits; else ``chunked_cross_entropy`` in
    chunks of up to 512 positions) plus the MoE aux loss, plus 0.3 x the
    MTP loss where the config has an MTP block. Returns (total, metrics:
    ``loss``, ``aux_loss`` and ``mtp_loss``, detached). ``kernel="off"``
    (the default, the JAX package's ``impl="ref"``) differentiates
    through the plain versions; ``"auto"`` launches the kernels on the
    card and is allowed only where no input requires grad."""
    cfg = model.cfg
    x, positions, tgt, mask = embed_inputs(model, batch)
    h, aux = forward_hidden(model, x, positions, kernel=kernel)
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    table = _head_table(model)
    if cfg.family == "audio":
        # small vocab: full logits per codebook
        losses = []
        for k in range(cfg.n_codebooks):
            logits = layers.logits_from_hidden(table[k], h,
                                               cfg.final_softcap)
            lse = torch.logsumexp(logits, dim=-1)
            sel = torch.gather(logits, -1, tgt[..., k:k + 1].long())[..., 0]
            losses.append(torch.mean(lse - sel))
        main = torch.mean(torch.stack(losses))
    else:
        main = layers.chunked_cross_entropy(
            table, h, tgt, mask, chunk=min(512, h.shape[1]),
            final_cap=cfg.final_softcap, n_valid=cfg.vocab_size)
    total = main + aux
    metrics = {"loss": main.detach(), "aux_loss": aux.detach()}
    if cfg.mtp:
        mtp_loss = _mtp_loss(model, batch, h, positions, kernel)
        total = total + 0.3 * mtp_loss
        metrics["mtp_loss"] = mtp_loss.detach()
    return total, metrics


def _mtp_loss(model: LM, batch: dict[str, torch.Tensor], h: torch.Tensor,
              positions: torch.Tensor, kernel: str) -> torch.Tensor:
    """DeepSeek-style depth-1 multi-token prediction: predict t+2 from the
    main trunk's (normed) hidden state at t combined with the embedding
    of t+1."""
    cfg = model.cfg
    toks = batch["tokens"]                 # (B, S+1)
    p = model.mtp
    emb_next = model.embed.table[toks[:, 1:-1]].to(h.dtype)
    h_in = torch.cat([rmsnorm(p.h_norm, h[:, :-1], cfg.norm_eps),
                      rmsnorm(p.e_norm, emb_next, cfg.norm_eps)], dim=-1)
    x = layers.linear(p.proj, h_in)        # (B, S-1, D)
    x, _ = block_forward(p.block, x, cfg, positions[:, :-1], kernel)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    # the JAX package's chunk choice: the first of these that divides S-1
    n = x.shape[1]
    chunk = next(c for c in (512, 256, 128, 63, 1) if n % c == 0)
    return layers.chunked_cross_entropy(_head_table(model), x, toks[:, 2:],
                                        None, chunk=chunk,
                                        final_cap=cfg.final_softcap,
                                        n_valid=cfg.vocab_size)

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
Under a ``ShardCtx`` (``repro_torch.distributed``) each rank runs the
stack on its shard of the batch and, where ``ctx.seq`` splits the
sequence (serving: ``repro_torch.models.decode``; training: the fsdp
recipe's train layout with two pods), on its block of positions of
those rows, attention gathering K and V over ``seq``; the MoE layers
are expert-parallel: ``_run_moe`` is the JAX package's ``shard_map``
path written out in collectives.

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

import contextlib
import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt_utils

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives, tp
from repro_torch.distributed.ctx import (ShardCtx, batch_axes, check_seq,
                                        seq_axes)
from repro_torch.models import attention as attn
from repro_torch.models import layers, mla, moe, rglru, ssd
from repro_torch.models.layers import mlp, rmsnorm
from repro_torch.tracing import counted_in_step

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


def init_parts(generator: torch.Generator, cfg: ModelConfig):
    """The model's parts in the order ``init`` draws them, one at a time,
    as (name, module): ``embed``, ``patch_proj`` (a VLM), ``blocks.<i>``
    in layer order, ``final_norm``, ``lm_head`` (an untied head) and
    ``mtp`` (deepseek). A part's parameter ``w`` is the model's
    ``<name>.w``. A sharded init (``repro_torch.distributed.sharding
    .ShardedModel``) keeps each part's shard and drops the rest before
    the next is drawn; the draws are ``init``'s, bit for bit."""
    dev = generator.device
    vocab = cfg.vocab_padded
    audio = cfg.family == "audio"

    def lm_head():
        shape = ((cfg.n_codebooks, cfg.d_model, vocab) if audio
                 else (cfg.d_model, vocab))
        head = layers.Linear(shape, device=dev)
        for w in (head.w if audio else [head.w]):
            w.copy_(layers.truncated_normal(
                (cfg.d_model, vocab), cfg.d_model**-0.5, generator))
        return head

    def mtp():
        return MTP(layers.init_linear(generator, 2 * cfg.d_model,
                                      cfg.d_model),
                   layers.RMSNorm(cfg.d_model, dev),
                   layers.RMSNorm(cfg.d_model, dev),
                   init_block(generator, cfg,
                              "mla" if cfg.mla else "global"))

    parts = [("embed", lambda: layers.init_embedding(
        generator, vocab, cfg.d_model,
        n_tables=cfg.n_codebooks if audio else 0))]
    if cfg.patch_stub is not None:
        parts.append(("patch_proj", lambda: layers.init_linear(
            generator, cfg.patch_stub.embed_dim, cfg.d_model)))
    parts += [(f"blocks.{i}", functools.partial(init_block, generator, cfg,
                                                kind))
              for i, kind in enumerate(cfg.layer_kinds)]
    parts.append(("final_norm", lambda: layers.RMSNorm(cfg.d_model, dev)))
    if not cfg.tie_embeddings:
        parts.append(("lm_head", lm_head))
    if cfg.mtp:
        parts.append(("mtp", mtp))
    for name, make in parts:
        with torch.no_grad():
            part = make()
        yield name, part


def init(generator: torch.Generator, cfg: ModelConfig) -> LM:
    """A model with random weights drawn from ``generator``, on its
    device, from the JAX package's distributions (not its bits). A
    ``layers.MetaGenerator`` builds it on the meta device (shapes and
    dtypes only)."""
    parts = dict(init_parts(generator, cfg))
    blocks = [parts[f"blocks.{i}"] for i in range(len(cfg.layer_kinds))]
    return LM(cfg, parts["embed"], blocks, parts["final_norm"],
              parts.get("lm_head"), parts.get("patch_proj"),
              parts.get("mtp"))


def _head_table(model: LM) -> torch.Tensor:
    """(V, D) table used for output logits, or (K, V, D) for audio: the
    embedding where the head is tied, else a transposed view of
    ``lm_head.w`` (stored (D, V) / (K, D, V), as in JAX; no copy)."""
    if model.cfg.tie_embeddings:
        return model.embed.table
    return model.lm_head.w.transpose(-1, -2)


class _Routed:
    """The routed part of an MoE module (router and expert weights,
    without the shared expert), as ``moe.moe_mlp`` reads it."""

    def __init__(self, p: moe.MoE):
        self.router, self.w_up, self.w_out = p.router, p.w_up, p.w_out
        if hasattr(p, "w_gate"):
            self.w_gate = p.w_gate


def _ep_slice(ctx: ShardCtx, e: int) -> tuple[int, int]:
    """(e_start, e_local): the experts of this rank, its index over
    ``ctx.ep_axes`` (major to minor) times ``e / |ep|``."""
    sizes = collectives.mesh_sizes(ctx.mesh)
    ep_size = 1
    for a in ctx.ep_axes:
        ep_size *= sizes[a]
    if e % ep_size:
        raise ValueError(f"{e} experts do not split over the {ep_size} "
                         f"ranks of {ctx.ep_axes}")
    e_local = e // ep_size
    idx = collectives.flat_index(collectives.mesh_coords(ctx.mesh), sizes,
                                 ctx.ep_axes)
    return idx * e_local, e_local


def _run_moe(p: moe.MoE, x: torch.Tensor, cfg: ModelConfig,
             capacity: int | None = None, ctx: ShardCtx | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer: ``moe_mlp`` over every expert on one device; under
    a ctx, expert parallelism over ``ctx.ep_axes``, as the JAX package's
    ``shard_map`` runs it. ``p`` then holds this rank's experts
    (``_ep_slice``) and the full router. The tokens are all-gathered over
    the EP axes that shard them (``gather_axes``: those of ``ctx.batch``
    along the rows, those of ``ctx.seq`` — a sequence-sharded prefill —
    along the sequence; the train layout with two pods splits the
    sequence over ``pod``, off the EP axes, so each pod rank's group
    routes its own block); the partial outputs of the local experts are
    summed over the EP axes that replicate the tokens (``psum_axes``) and
    reduce-scattered back over the others, in
    float32, rounded once to the activations' dtype after (as the
    one-device sum over a token's k choices rounds once). The
    shared expert runs outside the EP region (inside, the sum would count
    it |ep| times). The aux loss is the EP group's: every EP rank routes
    the same tokens with the same full router, so the JAX package's mean
    over the EP ranks is each one's own value."""
    mcfg = cfg.moe
    if ctx is None:
        return moe.moe_mlp(p, x, mcfg, cfg.mlp_act, capacity=capacity)
    mesh, ep_axes = ctx.mesh, tuple(ctx.ep_axes)
    e_start, e_local = _ep_slice(ctx, mcfg.padded_experts)
    if p.w_up.shape[0] != e_local:
        raise ValueError(f"the MoE holds {p.w_up.shape[0]} experts, this "
                         f"rank's slice of {ep_axes} is {e_local}")
    b_axes, s_axes = batch_axes(ctx), seq_axes(ctx)
    gather_axes = [(a, 0 if a in b_axes else 1) for a in ep_axes
                   if a in b_axes or a in s_axes]
    psum_axes = [a for a in ep_axes if a not in b_axes and a not in s_axes]
    xg = x
    for a, dim in gather_axes:
        xg = collectives.gather(xg, mesh, (a,), dim)
    y, aux = moe.moe_mlp(_Routed(p), xg, mcfg, cfg.mlp_act, e_start=e_start,
                         e_local=e_local, capacity=capacity,
                         out_dtype=torch.float32)
    if psum_axes:
        y = collectives.sum_over(y, mesh, psum_axes)
    for a, dim in reversed(gather_axes):
        y = collectives.scatter_sum(y, mesh, (a,), dim)
    y = y.to(x.dtype)
    if hasattr(p, "shared"):
        y = y + mlp(p.shared, x, cfg.mlp_act)
    return y, aux


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
                  capacity: int | None = None, ctx: ShardCtx | None = None
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
        # the host's time enqueuing the MoE layers, in a served copy's step
        with counted_in_step("moe_ns", "repro.moe"):
            h, aux = _run_moe(p.mlp, h, cfg, capacity=capacity, ctx=ctx)
    else:
        h = mlp(p.mlp, h, cfg.mlp_act)
    if cfg.post_norm:
        h = rmsnorm(p.post_mlp_norm, h, cfg.norm_eps)
    return x + h, aux


def block_forward(p: Block, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, kernel: str,
                  ctx: ShardCtx | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One residual block over a full sequence, no cache. Returns (x,
    aux loss or None). Under a ctx, ``x`` is this rank's shard of the
    batch (and, under ``ctx.seq``, its block of positions, attention
    gathering K and V over ``seq``); the MoE talks to other ranks too."""
    check_seq(ctx, p.kind)
    h = rmsnorm(p.pre_norm, x, cfg.norm_eps)
    if p.kind == "rec":
        h = rglru.rglru_block(p.mixer, h, cfg.rglru, kernel=kernel)
    elif p.kind == "ssd":
        h = ssd.ssd_block(p.mixer, h, cfg.ssm, kernel=kernel)
    elif p.kind == "mla":
        h = mla.mla_attention(p.mixer, h, positions, cfg=cfg.mla,
                              rope_theta=cfg.rope_theta, eps=cfg.norm_eps)
    else:
        h = attn.attention(p.mixer, h, positions, ctx=ctx,
                           **_attn_kw(cfg, p.kind, kernel))
    if cfg.post_norm:
        h = rmsnorm(p.post_mixer_norm, h, cfg.norm_eps)
    return _mlp_residual(p, x + h, cfg, ctx=ctx)


def _using(use, parts):
    """``use(parts)``, a sharded model's gather of those parts for the
    length of a ``with`` (``ShardedModel.use``), or nothing: a whole
    model holds its parameters."""
    return use(parts) if use is not None else contextlib.nullcontext()


def forward_hidden(model: LM, x: torch.Tensor, positions: torch.Tensor, *,
                   kernel: str = "off", ctx: ShardCtx | None = None,
                   use=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Embedded inputs (B, S, D) -> final hidden states, no cache.
    Returns (h, aux loss float32). With ``cfg.remat`` and grad enabled,
    each repeat of ``cfg.pattern`` is recomputed in backward
    (``torch.utils.checkpoint``), as ``jax.checkpoint`` does over the JAX
    package's scanned superblocks under ``remat_policy="full"`` (the
    policy of every config; ``"dots"`` raises); ``cfg.prefix``/``suffix``
    are not. Under a ctx ``x`` is this rank's shard of the batch and,
    under ``ctx.seq``, its block of positions (``positions`` the global
    ones). ``use``: see
    ``loss_fn``; each group of blocks (a repeat, or a block of the prefix
    or suffix) is gathered inside its forward, and so inside its
    recompute too."""
    cfg = model.cfg
    blocks = list(model.blocks)
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    n_rep = n_pre + cfg.repeats * n_pat
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(h, span):
        aux_sb = None
        with _using(use, [f"blocks.{i}" for i in span]):
            for i in span:
                h, aux = block_forward(blocks[i], h, cfg, positions, kernel,
                                       ctx)
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
    spans = ([range(i, i + 1) for i in range(n_pre)]
             + [range(i, i + n_pat) for i in range(n_pre, n_rep, n_pat)]
             + [range(i, i + 1) for i in range(n_rep, len(blocks))])
    for gi, span in enumerate(spans):
        repeat = n_pre <= gi < n_pre + cfg.repeats
        x, aux = (run if repeat else body)(x, span)
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
            x = x + layers.rows(tables[k], tokens[..., k])
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


def seq_block(ctx: ShardCtx | None, *ts: torch.Tensor
              ) -> tuple[torch.Tensor, ...]:
    """This rank's block of positions (dim 1) of each of ``ts`` under
    ``ctx.seq``, the block of index i over ``seq`` (major to minor) the
    i-th; the tensors as given without a split sequence. The length must
    divide by the ranks of ``seq``."""
    axes = seq_axes(ctx)
    if not axes:
        return ts
    n, s = tp.axes_size(ctx.mesh, axes), ts[0].shape[1]
    if s % n:
        raise ValueError(f"a sequence of {s} positions does not split over "
                         f"the {n} ranks of {axes}")
    start = tp.axes_index(ctx.mesh, axes) * (s // n)
    return tuple(t.narrow(1, start, s // n) for t in ts)


class _Shares:
    """Under a ctx, a rank's loss is its SHARE of the global loss: the
    sum of the shares over every rank of the mesh is the loss of the
    whole batch, and the sum over the ranks of their gradients is its
    gradient (the convention of ``repro_torch.distributed.collectives``).
    A cross entropy's share is the rank's sum of per-position losses over
    the global count of valid targets, divided by the number of ranks
    that hold the same positions of the same rows (``n_rep``: the world
    over the ranks of ``ctx.batch`` and ``ctx.seq``; ranks along ``seq``
    hold disjoint positions of the same rows). An aux loss's share is
    its routing group's value over the world size (its mean over the
    groups): as in the JAX package's ``_run_moe``, whose every
    ``shard_map`` instance routes its own block of tokens, a group is
    the EP ranks that gather one block of rows and, under ``ctx.seq``,
    of positions (``_run_moe``), and each routes with the capacity of
    its own block."""

    def __init__(self, ctx: ShardCtx):
        self.ctx = ctx
        sizes = collectives.mesh_sizes(ctx.mesh)
        self.axes = tuple(ctx.mesh.mesh_dim_names)
        self.world = 1
        for n in sizes.values():
            self.world *= n
        split = 1
        for a in batch_axes(ctx) + seq_axes(ctx):
            split *= sizes[a]
        self.n_rep = self.world // split

    def ce(self, total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        count = collectives.all_reduce(count.detach(), self.ctx.mesh,
                                       self.axes) / self.n_rep
        return total / torch.clamp(count, min=1.0) / self.n_rep

    def aux(self, aux: torch.Tensor) -> torch.Tensor:
        return aux / self.world

    def value(self, share: torch.Tensor) -> torch.Tensor:
        """The global value of a share: its sum over the ranks."""
        return collectives.all_reduce(share.detach(), self.ctx.mesh,
                                      self.axes)


# the parts of a model outside its block stack (``init_parts``' names)
OUTER_PARTS = ("embed", "patch_proj", "final_norm", "lm_head", "mtp")


def loss_fn(model: LM, batch: dict[str, torch.Tensor], *,
            kernel: str = "off", ctx: ShardCtx | None = None, use=None
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The training loss: next-token cross entropy (audio: the mean over
    the K codebooks' full logits; else ``chunked_cross_entropy`` in
    chunks of up to 512 positions) plus the MoE aux loss, plus 0.3 x the
    MTP loss where the config has an MTP block. Returns (total, metrics:
    ``loss``, ``aux_loss`` and ``mtp_loss``, detached). ``kernel="off"``
    (the default, the JAX package's ``impl="ref"``) differentiates
    through the plain versions; ``"auto"`` launches the kernels on the
    card and is allowed only where no input requires grad.

    Under a ctx, ``batch`` is this rank's rows of the global batch and
    ``model`` is a ``repro_torch.distributed.sharding.ShardedModel``'s
    ``model``, whose parameters ``use(parts)`` gathers (whole, but this
    rank's experts) for the length of a ``with``: the parts of
    ``OUTER_PARTS`` for the whole loss, each block inside its forward
    (``forward_hidden``); ``ShardedModel.loss`` passes it. ``total`` is
    the rank's share of the global loss (``_Shares``) and the metrics
    are the global values, the same on every rank. As in the JAX
    package, the MoE's capacity and aux loss are each EP group's. Under
    ``ctx.seq`` the rows are whole: each rank embeds them (a VLM's
    patches first) and keeps its block of positions (``seq_block``) of
    the inputs, targets, mask and global positions."""
    with _using(use, OUTER_PARTS):
        return _loss(model, batch, kernel, ctx, use)


def _loss(model: LM, batch: dict[str, torch.Tensor], kernel: str,
          ctx: ShardCtx | None, use):
    cfg = model.cfg
    shares = _Shares(ctx) if ctx is not None else None
    x, positions, tgt, mask = seq_block(ctx, *embed_inputs(model, batch))
    h, aux = forward_hidden(model, x, positions, kernel=kernel, ctx=ctx,
                            use=use)
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
            losses.append(torch.sum(lse - sel) if shares else
                          torch.mean(lse - sel))
        main = torch.mean(torch.stack(losses))
        if shares:
            main = shares.ce(main, torch.tensor(float(lse.numel()),
                                                device=main.device))
    elif shares:
        main = shares.ce(*layers.chunked_ce_sums(
            table, h, tgt, mask, chunk=min(512, h.shape[1]),
            final_cap=cfg.final_softcap, n_valid=cfg.vocab_size))
    else:
        main = layers.chunked_cross_entropy(
            table, h, tgt, mask, chunk=min(512, h.shape[1]),
            final_cap=cfg.final_softcap, n_valid=cfg.vocab_size)
    if shares:
        aux = shares.aux(aux)
    total = main + aux
    metrics = {"loss": main.detach(), "aux_loss": aux.detach()}
    if cfg.mtp:
        mtp_loss = _mtp_loss(model, batch, h, positions, kernel, shares)
        total = total + 0.3 * mtp_loss
        metrics["mtp_loss"] = mtp_loss.detach()
    if shares:
        metrics = {k: shares.value(v) for k, v in metrics.items()}
    return total, metrics


def _mtp_loss(model: LM, batch: dict[str, torch.Tensor], h: torch.Tensor,
              positions: torch.Tensor, kernel: str,
              shares: _Shares | None = None) -> torch.Tensor:
    """DeepSeek-style depth-1 multi-token prediction: predict t+2 from the
    main trunk's (normed) hidden state at t combined with the embedding
    of t+1 (under a ctx, this rank's share)."""
    cfg = model.cfg
    if shares and seq_axes(shares.ctx):
        # the only MTP model (deepseek) takes the tp recipe, whose
        # layouts never split the sequence
        raise NotImplementedError("the MTP loss over a split sequence")
    toks = batch["tokens"]                 # (B, S+1)
    p = model.mtp
    emb_next = model.embed.table[toks[:, 1:-1]].to(h.dtype)
    h_in = torch.cat([rmsnorm(p.h_norm, h[:, :-1], cfg.norm_eps),
                      rmsnorm(p.e_norm, emb_next, cfg.norm_eps)], dim=-1)
    x = layers.linear(p.proj, h_in)        # (B, S-1, D)
    x, _ = block_forward(p.block, x, cfg, positions[:, :-1], kernel,
                         shares.ctx if shares else None)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    # the JAX package's chunk choice: the first of these that divides S-1
    n = x.shape[1]
    chunk = next(c for c in (512, 256, 128, 63, 1) if n % c == 0)
    args = (_head_table(model), x, toks[:, 2:], None)
    kw = dict(chunk=chunk, final_cap=cfg.final_softcap,
              n_valid=cfg.vocab_size)
    if shares:
        return shares.ce(*layers.chunked_ce_sums(*args, **kw))
    return layers.chunked_cross_entropy(*args, **kw)

"""Config system: frozen dataclasses + an architecture registry.

A copy of the JAX package's ``configs/base.py`` (it imports no JAX). Every
architecture registers a full-size config and a ``smoke()`` reduction of
the same family (used by the CPU tests). ``InputShape``, ``SHAPES`` and
``cells`` are the dry-run's (arch x input shape) cells: the
model-parallel layer (ROADMAP queue 1 item 14e) reads them for its
layouts and ``launch/specs.py`` for its stand-ins; the dry-run itself is
item 15.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0           # shared (always-on) experts, deepseek-style
    d_shared: int = 0           # width of the shared expert(s)
    first_dense: int = 0        # leading dense layers (deepseek: 3)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    @property
    def padded_experts(self) -> int:
        """Experts padded up so EP over a 16-way model axis divides evenly
        (granite: 40 -> 48); padded experts are masked in the router."""
        ep = 16
        return ((self.n_experts + ep - 1) // ep) * ep


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin recurrent block."""
    lru_width: int = 0          # 0 = d_model
    conv_width: int = 4
    c_exponent: float = 8.0     # the a = a_base^(c * r) temperature


@dataclasses.dataclass(frozen=True)
class PatchStub:
    """Modality frontend stub: input_specs() provides precomputed
    frame/patch embeddings of this shape; the backbone owns the projector."""
    n_patches: int
    embed_dim: int


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer pattern: prefix + pattern * repeats + suffix must cover n_layers.
    # entries: "global" | "local" | "mla" | "moe" | "mla_moe" | "ssd" | "rec"
    prefix: tuple[str, ...] = ()
    pattern: tuple[str, ...] = ("global",)
    suffix: tuple[str, ...] = ()

    window: int = 4096               # local-attention window
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False
    mlp_act: str = "silu"            # silu | gelu | relu2 (squared relu)
    gated_mlp: bool = True           # False => plain 2-matrix MLP
    use_bias: bool = False
    rope_theta: float = 10_000.0
    rope_local_theta: float | None = None
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: scale embeddings by sqrt(d)
    post_norm: bool = False          # gemma2/3 sandwich norms
    norm_eps: float = 1e-6

    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    mtp: bool = False                # deepseek multi-token prediction head

    n_codebooks: int = 1             # musicgen: 4 parallel codebooks
    patch_stub: PatchStub | None = None

    # distribution recipe: "tp" (megatron heads/ffn over model axis) or
    # "fsdp" (batch over data x model, ZeRO params; for archs whose head
    # count does not divide the 16-way model axis)
    recipe: str = "tp"
    # training memory recipe
    optimizer: str = "adamw"         # adamw | adafactor
    remat: bool = True
    remat_policy: str = "full"       # full | dots (save matmul outputs)
    scan_layers: bool = True

    # serving
    long_context_ok: bool = True     # False => long_500k shape is skipped

    def __post_init__(self) -> None:
        n_pat = len(self.prefix) + len(self.suffix)
        rem = self.n_layers - n_pat
        if self.pattern:
            if rem % len(self.pattern) != 0:
                raise ValueError(
                    f"{self.name}: {self.n_layers} layers cannot be tiled by "
                    f"pattern {self.pattern} + prefix/suffix {n_pat}")

    @property
    def repeats(self) -> int:
        rem = self.n_layers - len(self.prefix) - len(self.suffix)
        return rem // len(self.pattern)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 when not 16-divisible, so
        the embedding/logits can always be vocab-parallel (mamba2's 50280,
        granite's 49155). Padded logit columns are masked in the loss."""
        if self.vocab_size % 16 == 0:
            return self.vocab_size
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        return self.prefix + self.pattern * self.repeats + self.suffix

    @property
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (self.n_codebooks if self.family == "audio" else 1)
        if not self.tie_embeddings:
            total += v * d * (self.n_codebooks if self.family == "audio" else 1)
        if self.patch_stub:
            total += self.patch_stub.embed_dim * d
        for kind in self.layer_kinds:
            total += self._block_params(kind)
        return total

    @property
    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds:
            total += self._block_params(kind, active=True)
        return total

    def _block_params(self, kind: str, active: bool = False) -> int:
        d = self.d_model
        n = 0
        # mixer
        if kind in ("global", "local", "global_moe"):
            n += d * self.n_heads * self.head_dim * 2  # wq, wo
            n += d * self.n_kv_heads * self.head_dim * 2  # wk, wv
        elif kind in ("mla", "mla_moe"):
            m = self.mla
            assert m is not None
            n += d * m.q_lora_rank
            n += m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            n += d * (m.kv_lora_rank + m.qk_rope_dim)
            n += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            n += self.n_heads * m.v_head_dim * d
        elif kind == "ssd":
            s = self.ssm
            assert s is not None
            di = s.expand * d
            n += d * (2 * di + 2 * s.d_state + di // s.head_dim)
            n += di * d
        elif kind == "rec":
            r = self.rglru
            assert r is not None
            w = r.lru_width or d
            n += d * w * 2 + w * d + w * (r.conv_width + 3)
        # mlp
        if kind in ("moe", "mla_moe", "global_moe"):
            mo = self.moe
            assert mo is not None
            per = d * mo.d_expert * (3 if self.gated_mlp else 2)
            routed = mo.top_k if active else mo.n_experts
            n += per * routed
            n += mo.n_shared * d * (mo.d_shared or mo.d_expert) * 3
            n += d * mo.n_experts  # router
        elif kind in ("global", "local", "mla", "dense", "rec"):
            n += d * self.d_ff * (3 if self.gated_mlp else 2)
        return n


# ---------------------------------------------------------------------------
# Shapes (assigned) + registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch import configs  # noqa: F401 - triggers registration
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    if name not in _SMOKE:
        from repro_torch import configs  # noqa: F401
    return _SMOKE[name]()


def list_architectures() -> list[str]:
    from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)


def cells(name: str) -> list[InputShape]:
    """The (arch x shape) cells that are RUN for this arch; long_500k is
    skipped for pure full-attention archs (documented in DESIGN.md)."""
    cfg = get_config(name)
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.long_context_ok:
        out.append(SHAPES["long_500k"])
    return out

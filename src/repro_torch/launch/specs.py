"""Meta-device stand-ins for every (arch x input-shape) cell.

The port of ``repro.launch.specs``: the model inputs (token grids, patch
embeddings, decode caches), the parameters and the optimizer state as
tensors on ``torch.device("meta")`` — shapes and dtypes, no memory, so
deepseek-v3-671b's 671B parameters cost nothing. The sharding rules
(``repro_torch.distributed.sharding``) and the dry-run (ROADMAP item 15)
read these.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import decode as dec
from repro_torch.models import layers, lm

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: InputShape) -> dict[str, Any]:
    """Training / prefill batch. Training batches carry S+1 tokens (shifted
    inside loss_fn); prefill batches carry the raw S-token prompt."""
    b, s = shape.global_batch, shape.seq_len
    extra = 1 if shape.kind == "train" else 0
    if cfg.family == "audio":
        return {"tokens": sds((b, s + extra, cfg.n_codebooks), torch.int32)}
    if cfg.patch_stub is not None:
        n_p = cfg.patch_stub.n_patches
        text = s - n_p
        assert text > 0, f"{cfg.name}: seq {s} <= n_patches {n_p}"
        return {
            "tokens": sds((b, text + extra), torch.int32),
            "patches": sds((b, n_p, cfg.patch_stub.embed_dim),
                           torch.float32),
        }
    return {"tokens": sds((b, s + extra), torch.int32)}


def decode_specs(cfg: ModelConfig, shape: InputShape) -> dict[str, Any]:
    """Decode step inputs: one new token + a cache of seq_len positions
    (the port's cache: one dict a layer, ``models.decode.init_cache``)."""
    b, s = shape.global_batch, shape.seq_len
    cache = dec.init_cache(cfg, b, s, META)
    if cfg.family == "audio":
        tokens = sds((b, 1, cfg.n_codebooks), torch.int32)
    else:
        tokens = sds((b, 1), torch.int32)
    return {"cache": cache, "tokens": tokens, "pos": sds((), torch.int32)}


def param_specs(cfg: ModelConfig) -> lm.LM:
    """The port's model built on the meta device."""
    return lm.init(layers.MetaGenerator(), cfg)


def opt_state_specs(cfg: ModelConfig, model: lm.LM) -> dict:
    """The optimizer state of ``cfg.optimizer`` over the meta model's
    parameters (Adafactor's keyed by JAX leaf, ``lm.leaf_groups``)."""
    from repro_torch.training.optimizer import make_optimizer

    opt = make_optimizer(cfg.optimizer)
    return opt.init(dict(model.named_parameters()), lm.leaf_groups(model))

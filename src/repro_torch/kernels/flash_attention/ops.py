"""Public flash-attention op: kernel dispatch.

``flash_attention`` takes the arguments of ``ref.flash_attention_ref``
plus a ``kernel=`` mode (see ``repro_torch.kernels.dispatch``): a CUDA
tensor launches the CUDA kernel under ``"auto"``/``"on"``, a CPU tensor
takes the plain version, ``"off"`` asks for the plain version on any
device. There is no block-size search: the kernel masks its tile edges,
so any sequence length works.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int | None = None, softcap: float | None = None,
                    kernel: str = "auto") -> torch.Tensor:
    """q (B, S, H, hd); k/v (B, S, KV, hd) -> (B, S, H, hd)."""
    if dispatch.use_kernel(kernel, q, k, v):
        return fa_kernel.flash_attention_cuda(q, k, v, window=window,
                                              softcap=softcap)
    return flash_attention_ref(q, k, v, window=window, softcap=softcap)

"""Public decode-attention op: kernel dispatch.

``decode_attention`` takes the arguments of ``ref.decode_attention_ref``
plus a ``kernel=`` mode (see ``repro_torch.kernels.dispatch``): a CUDA
tensor launches the CUDA kernels under ``"auto"``/``"on"``, a CPU tensor
takes the plain version, ``"off"`` asks for the plain version on any
device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     slot_pos: torch.Tensor, pos: int, *,
                     window: int | None = None,
                     softcap: float | None = None,
                     kernel: str = "auto") -> torch.Tensor:
    """q (B, 1, H, hd); k/v (B, L, KV, hd); slot_pos (L,) -> (B, 1, H, hd)."""
    if dispatch.use_kernel(kernel, q, k, v, slot_pos):
        return da_kernel.decode_attention_cuda(q, k, v, slot_pos, pos,
                                               window=window, softcap=softcap)
    return decode_attention_ref(q, k, v, slot_pos, pos, window=window,
                                softcap=softcap)

"""Public RG-LRU scan op: kernel dispatch.

``linear_scan`` takes the arguments of ``ref.linear_scan_ref`` (without
``h0``: the kernel starts from ``h_{-1} = 0``, as the TPU kernel does)
plus a ``kernel=`` mode (see ``repro_torch.kernels.dispatch``): a CUDA
tensor launches the CUDA kernel under ``"auto"``/``"on"``, a CPU tensor
takes the plain version, ``"off"`` asks for the plain version on any
device. Inputs are taken in float32, as the JAX wrapper casts them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan.ref import linear_scan_ref


def linear_scan(a: torch.Tensor, b: torch.Tensor, *,
                kernel: str = "auto") -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` along axis 1, ``h_{-1} = 0``. a/b (B, L,
    W) -> h (B, L, W) float32."""
    a, b = (t.to(torch.float32).contiguous() for t in (a, b))
    if dispatch.use_kernel(kernel, a, b):
        return scan_kernel.linear_scan_cuda(a, b)
    return linear_scan_ref(a, b)

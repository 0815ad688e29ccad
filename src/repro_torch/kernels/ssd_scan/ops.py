"""Public SSD intra-chunk op: kernel dispatch.

``ssd_intra_chunk`` takes the arguments of ``ref.ssd_intra_chunk_ref``
plus a ``kernel=`` mode (see ``repro_torch.kernels.dispatch``): a CUDA
tensor launches the CUDA kernel under ``"auto"``/``"on"``, a CPU tensor
takes the plain version, ``"off"`` asks for the plain version on any
device. Inputs are taken in float32, as the JAX wrapper casts them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref


def ssd_intra_chunk(xc: torch.Tensor, bc: torch.Tensor, cc: torch.Tensor,
                    dtc: torch.Tensor, cum: torch.Tensor, *,
                    kernel: str = "auto"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """xc (B, NC, Q, H, P); bc/cc (B, NC, Q, N); dtc/cum (B, NC, Q, H) ->
    y_intra (B, NC, Q, H, P), states (B, NC, H, P, N), float32."""
    xc, bc, cc, dtc, cum = (t.to(torch.float32).contiguous()
                            for t in (xc, bc, cc, dtc, cum))
    if dispatch.use_kernel(kernel, xc, bc, cc, dtc, cum):
        return ssd_kernel.ssd_intra_chunk_cuda(xc, bc, cc, dtc, cum)
    return ssd_intra_chunk_ref(xc, bc, cc, dtc, cum)

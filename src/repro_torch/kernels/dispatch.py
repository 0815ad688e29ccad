"""Kernel-mode dispatch shared by the ``ops`` modules.

Modes (the ``kernel=`` knob of ``repro_torch.core.queueing.run``):

  ``"auto"``  the CUDA kernel for CUDA tensors, the plain PyTorch
              version for CPU tensors.
  ``"on"``    the CUDA kernel; CPU tensors raise.
  ``"off"``   the plain PyTorch version on any device — an explicit
              request, used by the tests and by ``chip_smoke.py`` to
              hold a kernel against its plain version.

There is no fallback: a CUDA tensor under ``"auto"``/``"on"`` launches
the kernel, and a kernel that does not build or launch raises.

The CUDA kernels have no backward pass (nor have the TPU kernels: no
``pallas_call`` of the JAX package has a VJP). So a call that would
launch a kernel on a tensor that requires grad, with grad enabled,
raises instead of returning an output that silently cuts the gradient,
as ``jax.grad`` through a ``pallas_call`` without a VJP does. Training
asks for the plain versions (``kernel="off"``), as the JAX package
trains through ``impl="ref"``; an evaluation under ``torch.no_grad()``
may launch the kernels.
"""
from __future__ import annotations

import torch

KERNEL_MODES = ("auto", "on", "off")


def check_mode(kernel: str) -> str:
    if kernel not in KERNEL_MODES:
        raise ValueError(
            f"kernel must be one of {KERNEL_MODES}, got {kernel!r}")
    return kernel


def resolve(kernel: str, device) -> str:
    """The mode a call under ``kernel`` takes on ``device``: ``"on"`` (the
    CUDA kernel) or ``"off"`` (the plain version); see the module note."""
    check_mode(kernel)
    dev = torch.device(device)
    if kernel == "off":
        return "off"
    if dev.type == "cuda":
        return "on"
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    if kernel == "on":
        raise RuntimeError(
            "kernel='on' needs CUDA tensors; the CUDA kernels do not run "
            "on the CPU (kernel='auto' or 'off' takes the plain version)")
    return "off"


def use_kernel(kernel: str, *tensors: torch.Tensor) -> bool:
    """Whether this call launches the CUDA kernel (``resolve`` on the
    tensors' device). All ``tensors`` must share one device. A launch on
    a tensor that requires grad (grad enabled) raises: the kernels have
    no backward pass (see the module note)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors span several devices: {sorted(map(str, devices))}")
    if resolve(kernel, devices.pop()) != "on":
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the CUDA kernels have no backward pass: an input requires "
            "grad, and the kernel's output would cut its gradient; pass "
            "kernel='off' to differentiate through the plain version, or "
            "run under torch.no_grad()")
    return True

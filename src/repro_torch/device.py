"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``: ``"cuda"`` (the default of every
    entry point) or ``"cpu"``. Asking for CUDA where there is none
    raises — a run never carries on on the CPU unless the caller asked
    for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} needs CUDA, which is not available; "
                f"pass device='cpu' for the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev

"""Device resolution and seeded generators shared by the port's entry
points."""
from __future__ import annotations

import numpy as np
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


def seeded_generator(words, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the int sequence
    ``words`` (through ``numpy.random.SeedSequence``), so a stream is a
    pure function of those ints."""
    state = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen

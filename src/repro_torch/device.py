"""Device resolution, seeded generators and the card's published peaks,
shared by the port's entry points, its roofline and ``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense rates at 700 W):
# device memory rate, the float32 rate outside the tensor cores and the
# bf16 and TF32 tensor-core rates. The bounds and roofline fractions of
# the port are taken against these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
# NVLink 4 of the H100 SXM, as published (NVIDIA data sheet: 900 GB/s a
# GPU, 18 links, both directions together). Not measured: the machine
# the port runs on has one card. The dry run's collective term is taken
# against it.
NVLINK_BYTES_PER_S = 900e9


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

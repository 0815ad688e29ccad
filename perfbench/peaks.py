"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives. NVIDIA's H100 SXM data sheet:
dense bf16 989 TFLOP/s (no sparsity) and 3.35 TB/s of HBM3, at the full
700 W power limit; a card set lower reaches less (the run prints its
limit)."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops_per_s": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict | None:
    """The card's peaks, or None for a device without published ones
    (then no roofline or MFU is read)."""
    return PEAKS.get(kind)

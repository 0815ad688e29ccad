"""ctypes wrapper of the CUDA ``rglru_scan`` kernel
(``repro_torch/csrc/rglru_scan.cu``).

The library is built by ``repro_torch.kernels.build`` the first time the
kernel is launched, never when this module is imported.
``linear_scan_cuda.launches`` counts launches of the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.kernel import check_f32

_VP, _I = ctypes.c_void_p, ctypes.c_int
# replicas launch from their own threads; the count's += is not atomic
_COUNT_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    lib.rglru_scan_launch.restype = _I
    lib.rglru_scan_launch.argtypes = [_VP] * 3 + [_I] * 4 + [_VP]
    return lib


def linear_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel twin of ``ref.linear_scan_ref`` with ``h0 = None``: a/b (B,
    L, W) contiguous float32 on one CUDA device -> h (B, L, W), computed on
    the current stream; equal to the plain version bit for bit."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"linear_scan_cuda needs CUDA tensors, got {dev}")
    check_f32("a", a, a.shape, dev)
    check_f32("b", b, a.shape, dev)
    if a.dim() != 3:
        raise ValueError(f"a and b must be (B, L, W), got {tuple(a.shape)}")
    h = torch.empty_like(a)
    if a.numel() == 0:
        return h
    bsz, length, width = a.shape
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                   bsz, length, width, dev.index or 0, stream)
    build.check(lib, status, "rglru_scan kernel launch")
    with _COUNT_LOCK:
        linear_scan_cuda.launches += 1
    return h


linear_scan_cuda.launches = 0

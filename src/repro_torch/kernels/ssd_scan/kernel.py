"""ctypes wrapper of the CUDA ``ssd_scan`` kernels
(``repro_torch/csrc/ssd_scan.cu``: C B^T once per chunk, the intra-chunk
output and the chunk states).

The library is built by ``repro_torch.kernels.build`` the first time the
kernel is launched, never when this module is imported.
``ssd_intra_chunk_cuda.launches`` counts calls that launch the three.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

MAX_P, MAX_N = 128, 256  # kMaxP, kMaxN in ssd_scan.cu

_VP, _I = ctypes.c_void_p, ctypes.c_int
# replicas launch from their own threads; the count's += is not atomic
_COUNT_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan_launch.restype = _I
    lib.ssd_scan_launch.argtypes = [_VP] * 8 + [_I] * 6 + [_VP]
    return lib


def check_f32(name: str, x: torch.Tensor, shape, device) -> None:
    """Raise unless ``x`` is a contiguous float32 tensor of ``shape`` on
    ``device`` (what the recurrent kernels take)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ssd_intra_chunk_cuda(xc: torch.Tensor, bc: torch.Tensor,
                         cc: torch.Tensor, dtc: torch.Tensor,
                         cum: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel twin of ``ref.ssd_intra_chunk_ref``: xc (B, NC, Q, H, P),
    bc/cc (B, NC, Q, N), dtc/cum (B, NC, Q, H), contiguous float32 on one
    CUDA device, ``P <= 128`` and ``N <= 256``. Returns y_intra (B, NC, Q,
    H, P) and states (B, NC, H, P, N), computed on the current stream."""
    dev = xc.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_intra_chunk_cuda needs CUDA tensors, got {dev}")
    b, nc, q, h, p = xc.shape
    n = bc.shape[-1]
    check_f32("xc", xc, (b, nc, q, h, p), dev)
    check_f32("bc", bc, (b, nc, q, n), dev)
    check_f32("cc", cc, (b, nc, q, n), dev)
    check_f32("dtc", dtc, (b, nc, q, h), dev)
    check_f32("cum", cum, (b, nc, q, h), dev)
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"head_dim P={p} must be at most {MAX_P} and "
                         f"d_state N={n} at most {MAX_N}")
    y = torch.empty_like(xc)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=dev)
    if xc.numel() == 0 or n == 0:
        return y.zero_(), states.zero_()
    scores = torch.empty((b * nc, q, q), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.ssd_scan_launch(
        xc.data_ptr(), bc.data_ptr(), cc.data_ptr(), dtc.data_ptr(),
        cum.data_ptr(), y.data_ptr(), states.data_ptr(), scores.data_ptr(),
        b * nc, q, h, p, n, dev.index or 0, stream)
    build.check(lib, status, "ssd_scan kernel launch")
    with _COUNT_LOCK:
        ssd_intra_chunk_cuda.launches += 1
    return y, states


ssd_intra_chunk_cuda.launches = 0

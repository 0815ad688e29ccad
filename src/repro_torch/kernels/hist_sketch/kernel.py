"""ctypes wrapper of the CUDA ``hist_accum`` kernel
(``repro_torch/csrc/hist_sketch.cu``).

The library is built by ``repro_torch.kernels.build`` the first time a
kernel is launched, never when this module is imported.
``hist_accum_cuda.launches`` counts the launches of the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# A block's shared-memory int32 histogram must fit the 227 KB a block
# can use on Hopper (one cell's row at least).
MAX_SMEM_BYTES = 232_448
MAX_BINS = MAX_SMEM_BYTES // 4

_VP, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("hist_sketch")
    lib.hist_accum_launch.restype = _I
    lib.hist_accum_launch.argtypes = [_VP, _VP, _I, _I, _I, _I, _VP]
    return lib


def hist_accum_cuda(idx: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Add the log-bin counts of ``idx`` (T, C) int32 in [-1, n_bins)
    into ``out`` (C, n_bins) float32, in place, on the current stream;
    returns ``out``. Entries of -1 are skipped; indices at or above
    ``n_bins`` count in the top bin, as in the plain version."""
    if idx.device.type != "cuda" or out.device != idx.device:
        raise ValueError("hist_accum_cuda needs idx and out on one CUDA "
                         f"device, got {idx.device} / {out.device}")
    if idx.dtype != torch.int32 or out.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and out float32, got "
                        f"{idx.dtype} / {out.dtype}")
    if idx.ndim != 2 or out.ndim != 2 or out.shape[0] != idx.shape[1]:
        raise ValueError(f"shapes idx (T, C) / out (C, n_bins) disagree: "
                         f"{tuple(idx.shape)} / {tuple(out.shape)}")
    if not (idx.is_contiguous() and out.is_contiguous()):
        raise ValueError("hist_accum_cuda needs contiguous tensors")
    t, c = idx.shape
    n_bins = out.shape[1]
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins} must be in [1, {MAX_BINS}] (one "
                         f"cell's histogram lives in shared memory)")
    if t == 0 or c == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    status = lib.hist_accum_launch(idx.data_ptr(), out.data_ptr(), t, c,
                                   n_bins, idx.device.index or 0, stream)
    build.check(lib, status, "hist_accum kernel launch")
    hist_accum_cuda.launches += 1
    return out


hist_accum_cuda.launches = 0

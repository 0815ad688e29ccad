"""ctypes wrapper of the CUDA ``flash_attention`` kernel
(``repro_torch/csrc/flash_attention.cu``).

The library is built by ``repro_torch.kernels.build`` the first time the
kernel is launched, never when this module is imported.
``flash_attention_cuda.launches`` counts launches of the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)  # instances of the kernel's template

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# replicas launch from their own threads; the count's += is not atomic
_COUNT_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_launch.restype = _I
    lib.flash_attention_launch.argtypes = ([_VP] * 4 + [_I] * 6
                                           + [_F, _F, _I, _VP])
    return lib


def check_tensor(name: str, x: torch.Tensor, shape, device) -> None:
    """Raise unless ``x`` is a contiguous bf16 tensor of ``shape`` on
    ``device``, its data 16-byte aligned (what the attention kernels take:
    they copy rows 16 bytes at a time, and TMA needs the alignment)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16 != 0:
        raise ValueError(f"{name}'s data must be 16-byte aligned")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: int | None = None,
                         softcap: float | None = None) -> torch.Tensor:
    """Kernel twin of ``ref.flash_attention_ref``: q (B, S, H, hd), k/v
    (B, S, KV, hd), contiguous bf16 on one CUDA device, ``hd`` one of
    ``HEAD_DIMS`` and ``H`` a multiple of ``KV``. Returns (B, S, H, hd)
    bf16, computed on the current stream."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    check_tensor("q", q, (b, s, h, hd), dev)
    check_tensor("k", k, (b, s, kv, hd), dev)
    check_tensor("v", v, (b, s, kv, hd), dev)
    if h % kv != 0:
        raise ValueError(f"n_heads={h} is not a multiple of n_kv={kv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim={hd} must be one of {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        kv, hd, window or 0, softcap or 0.0, hd**-0.5, dev.index or 0,
        stream)
    build.check(lib, status, "flash_attention kernel launch")
    with _COUNT_LOCK:
        flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0

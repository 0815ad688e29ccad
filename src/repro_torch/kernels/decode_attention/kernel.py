"""ctypes wrapper of the CUDA ``decode_attention`` kernels
(``repro_torch/csrc/decode_attention.cu``: a split pass and a combine
pass).

The library is built by ``repro_torch.kernels.build`` the first time the
kernel is launched, never when this module is imported.
``decode_attention_cuda.launches`` counts calls that launch the pair.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import check_tensor

MAX_GROUP = 8  # kMaxGroup in decode_attention.cu: query heads per KV head

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# replicas launch from their own threads; the count's += is not atomic
_COUNT_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    lib.decode_attention_launch.restype = _I
    lib.decode_attention_launch.argtypes = ([_VP] * 8 + [_I] * 7
                                            + [_F, _F, _I, _VP])
    lib.decode_attention_split.restype = _I
    lib.decode_attention_split.argtypes = []
    return lib


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          slot_pos: torch.Tensor, pos: int, *,
                          window: int | None = None,
                          softcap: float | None = None) -> torch.Tensor:
    """Kernel twin of ``ref.decode_attention_ref``: q (B, 1, H, hd), k/v
    (B, L, KV, hd) contiguous bf16, slot_pos (L,) int32, on one CUDA
    device; ``H / KV`` at most 8 and ``hd`` a multiple of 16. Returns (B,
    1, H, hd) bf16, computed on the current stream."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"{dev}")
    b, _, h, hd = q.shape
    length, kv = k.shape[1], k.shape[2]
    check_tensor("q", q, (b, 1, h, hd), dev)
    check_tensor("k", k, (b, length, kv, hd), dev)
    check_tensor("v", v, (b, length, kv, hd), dev)
    if slot_pos.device != dev or slot_pos.dtype != torch.int32 or \
            tuple(slot_pos.shape) != (length,) or \
            not slot_pos.is_contiguous():
        raise ValueError(f"slot_pos must be contiguous int32 ({length},) on "
                         f"{dev}, got {slot_pos.dtype} "
                         f"{tuple(slot_pos.shape)} on {slot_pos.device}")
    if h % kv != 0 or h // kv > MAX_GROUP:
        raise ValueError(f"n_heads={h} must be a multiple of n_kv={kv}, at "
                         f"most {MAX_GROUP} times it")
    if hd % 16 != 0:
        raise ValueError(f"head_dim={hd} must be a multiple of 16")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    out = torch.empty_like(q)
    if q.numel() == 0 or length == 0:
        return out.zero_()
    lib = _lib()
    g = h // kv
    n_splits = -(-length // lib.decode_attention_split())
    f32 = torch.float32
    m_part = torch.empty((b, kv, n_splits, g), dtype=f32, device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b, kv, n_splits, g, hd), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
        out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
        acc_part.data_ptr(), b, length, h, kv, hd, int(pos), window or 0,
        softcap or 0.0, hd**-0.5, dev.index or 0, stream)
    build.check(lib, status, "decode_attention kernel launch")
    with _COUNT_LOCK:
        decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0

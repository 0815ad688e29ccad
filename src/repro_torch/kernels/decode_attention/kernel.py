"""ctypes wrapper of the CUDA ``decode_attention`` kernel
(``repro_torch/csrc/decode_attention.cu``: staged splits of the cache,
combined in the same launch).

The library is built by ``repro_torch.kernels.build`` the first time the
kernel is launched, never when this module is imported.
``decode_attention_cuda.launches`` counts launches of the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import check_tensor

MAX_GROUP = 16  # kMaxGroup in decode_attention.cu: query heads per KV head
MAX_HEAD_DIM = 256  # kMaxHeadDim
CLUSTER = 8     # kCluster: splits combined on chip by a thread-block cluster
MAX_SPLIT = 128  # kMaxSplit: cache slots a CTA stages
MIN_SPLIT = 4   # fewer slots a CTA only multiply the partials to combine

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# replicas launch from their own threads; the count's += is not atomic
_COUNT_LOCK = threading.Lock()
_SM_COUNT: dict[int, int] = {}
# per (device, stream): the combine's counters, zeroed once when allocated
# (every launch leaves them zero); launches on one stream never overlap
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    lib.decode_attention_launch.restype = _I
    lib.decode_attention_launch.argtypes = ([_VP] * 8 + [_I] * 7
                                            + [_F, _F, _I, _I, _I, _VP])
    for fn in (lib.decode_attention_cluster, lib.decode_attention_max_split):
        fn.restype = _I
        fn.argtypes = []
    lib.decode_attention_sm_count.restype = _I
    lib.decode_attention_sm_count.argtypes = [_I]
    if (lib.decode_attention_cluster(), lib.decode_attention_max_split()) \
            != (CLUSTER, MAX_SPLIT):
        raise RuntimeError("decode_attention.cu and its wrapper disagree on "
                           "the cluster size or the largest split")
    return lib


def split_plan(length: int, batch: int, n_kv: int,
               n_sm: int) -> tuple[int, int]:
    """(slots per split, number of splits) for a cache of ``length`` slots
    read by ``batch * n_kv`` (batch, KV head) pairs on a card of ``n_sm``
    SMs: enough splits that ``batch * n_kv * splits`` is at least twice
    ``n_sm`` where the cache is long enough for it (a split holds at
    least ``MIN_SPLIT`` slots and at most ``MAX_SPLIT``), rounded up to a
    multiple of ``CLUSTER``; the splits past the cache are empty."""
    if min(length, batch, n_kv, n_sm) < 1:
        raise ValueError(f"length, batch, n_kv and n_sm must be >= 1, got "
                         f"{(length, batch, n_kv, n_sm)}")
    want = max(-(-2 * n_sm // (batch * n_kv)), -(-length // MAX_SPLIT))
    split = min(MAX_SPLIT, max(MIN_SPLIT, length // want))
    n_splits = -(-length // split)
    return split, -(-n_splits // CLUSTER) * CLUSTER


def _sm_count(lib: ctypes.CDLL, index: int) -> int:
    n = _SM_COUNT.get(index)
    if n is None:
        n = lib.decode_attention_sm_count(index)
        if n <= 0:
            raise RuntimeError(f"cannot read the SM count of cuda:{index}")
        _SM_COUNT[index] = n
    return n


def _counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (dev.index or 0, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                         device=dev)
    return c


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          slot_pos: torch.Tensor, pos: int, *,
                          window: int | None = None,
                          softcap: float | None = None) -> torch.Tensor:
    """Kernel twin of ``ref.decode_attention_ref``: q (B, 1, H, hd), k/v
    (B, L, KV, hd) contiguous bf16, slot_pos (L,) int32, on one CUDA
    device; ``H / KV`` at most 16 and ``hd`` a multiple of 16 up to 256.
    Returns (B, 1, H, hd) bf16, computed on the current stream in one
    launch."""
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
    if hd % 16 != 0 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim={hd} must be a multiple of 16, at most "
                         f"{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    out = torch.empty_like(q)
    if q.numel() == 0 or length == 0:
        return out.zero_()
    lib = _lib()
    g = h // kv
    split, n_splits = split_plan(length, b, kv, _sm_count(lib, dev.index or 0))
    n_clusters = n_splits // CLUSTER
    f32 = torch.float32
    part_acc = torch.empty((b, kv, n_clusters, g * hd), dtype=f32, device=dev)
    part_ml = torch.empty((b, kv, n_clusters, CLUSTER, g, 2), dtype=f32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters = _counters(dev, stream, b * kv * CLUSTER)
    status = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        counters.data_ptr(), b, length, h, kv, hd, int(pos), window or 0,
        softcap or 0.0, hd**-0.5, split, n_splits, dev.index or 0, stream)
    build.check(lib, status, "decode_attention kernel launch")
    with _COUNT_LOCK:
        decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0

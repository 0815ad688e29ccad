"""ctypes wrapper of the CUDA ``cell_update`` kernel
(``repro_torch/csrc/cell_update.cu``).

The library is built by ``repro_torch.kernels.build`` the first time the
kernel is launched, never when this module is imported.
``cell_update_cuda.launches`` counts launches of the kernel; with the
sketch on, the per-step bin indices it writes are folded by the
``hist_accum`` kernel, which counts its own launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hist_sketch import ops as hist_ops
from repro_torch.kernels.hist_sketch.kernel import hist_accum_cuda

MAX_K = 16               # kMaxK in cell_update.cu
MAX_SMEM_BYTES = 232_448  # a block's N x 32 float free-time grid
THREADS = 32
MAX_SERVERS = MAX_SMEM_BYTES // (4 * THREADS)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load("cell_update")
    lib.cell_update_launch.restype = _I
    lib.cell_update_launch.argtypes = ([_VP] * 22 + [_I] * 7
                                       + [_F, _F, _I, _VP])
    return lib


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")


def prefix_counts(k_mask: torch.Tensor) -> torch.Tensor:
    """Copy counts (C,) int32 of the rows of ``k_mask`` (C, k_max) bool,
    which must be prefix masks. The check reads the device back, so the
    engine passes counts it built with the plan instead."""
    k_count = k_mask.sum(dim=1, dtype=torch.int32)
    iota = torch.arange(k_mask.shape[1], device=k_mask.device)
    if not torch.equal(k_mask, iota[None, :] < k_count[:, None]):
        raise ValueError("k_mask rows must be prefix masks")
    return k_count


def cell_update_cuda(free, ssum, comp, cnt, hist, cum, warm, valid, servers,
                     services, seed_idx, rates, k_mask, ovh, policy_code,
                     model_code, mix, p_slow, slow_factor, p_fail, delay,
                     svc_idx=None, *, n_bins: int, has_shared: bool = False,
                     has_dists: bool = False, k_count=None):
    """Kernel twin of ``ref.cell_update_ref`` (same arguments, same bits,
    no ``block`` staging): validates the layout, allocates the outputs
    and launches on the current stream. ``k_mask`` rows must be prefix
    masks; they travel as per-cell copy counts, ``k_count`` (C,) int32
    when the caller has them (the engine does), else ``prefix_counts``.
    Index and code tensors of another integer dtype are cast to int32."""
    dev = free.device
    if dev.type != "cuda":
        raise ValueError(f"cell_update_cuda needs CUDA tensors, got {dev}")
    C, N = free.shape
    S, T = cum.shape
    k_max = k_mask.shape[1]
    n_svc = services.shape[-1]
    need_hist = hist.numel() > 0
    if not 1 <= k_max <= min(MAX_K, N):
        raise ValueError(f"k_max={k_max} must be in [1, min({MAX_K}, N={N})]")
    if N > MAX_SERVERS:
        raise ValueError(f"n_servers={N} exceeds the kernel's "
                         f"{MAX_SERVERS} (free times live in shared memory)")
    if n_svc < k_max + int(has_shared):
        raise ValueError(f"services has {n_svc} columns, needs at least "
                         f"{k_max + int(has_shared)}")
    f32, i32 = torch.float32, torch.int32
    _check("free", free, f32, (C, N), dev)
    for name, x in (("ssum", ssum), ("comp", comp), ("cnt", cnt),
                    ("rates", rates), ("ovh", ovh), ("mix", mix),
                    ("p_slow", p_slow), ("slow_factor", slow_factor),
                    ("p_fail", p_fail), ("delay", delay)):
        _check(name, x, f32, (C,), dev)
    _check("warm", warm, f32, (T,), dev)
    _check("valid", valid, f32, (T,), dev)
    _check("servers", servers, i32, (S, T, k_max), dev)
    if services.dtype != f32 or services.ndim != 3 or \
            services.shape[1] != T or services.device != dev:
        raise ValueError(f"services must be float32 (rows, {T}, n_svc) on "
                         f"{dev}, got {services.dtype} "
                         f"{tuple(services.shape)} on {services.device}")
    _check("k_mask", k_mask, torch.bool, (C, k_max), dev)
    if need_hist:
        _check("hist", hist, f32, (C, n_bins), dev)
    if k_count is None:
        k_count = prefix_counts(k_mask)
    _check("k_count", k_count, i32, (C,), dev)
    svc_rows = svc_idx if has_dists else None
    if has_dists and svc_idx is None:
        raise ValueError("has_dists=True needs svc_idx")

    def i32c(x):
        return x.to(device=dev, dtype=i32).contiguous()

    seed32 = i32c(seed_idx)
    svc32 = i32c(svc_rows) if svc_rows is not None else None
    params = [seed32, svc32, k_count, i32c(policy_code), i32c(model_code),
              *(x.contiguous() for x in (rates, ovh, mix, p_slow,
                                         slow_factor, p_fail, delay))]
    free_o, ssum_o, comp_o, cnt_o = (x.clone(memory_format=torch.contiguous_format)
                                     for x in (free, ssum, comp, cnt))
    bins = torch.empty((T, C), dtype=i32, device=dev) if need_hist else None
    cum, warm, valid, servers, services = (
        x.contiguous() for x in (cum, warm, valid, servers, services))
    log_lo, scale = hist_ops.log_scale(n_bins) if need_hist else (0.0, 0.0)

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.cell_update_launch(
        ptr(free_o), ptr(ssum_o), ptr(comp_o), ptr(cnt_o), ptr(bins),
        ptr(cum), ptr(warm), ptr(valid), ptr(servers), ptr(services),
        *(ptr(x) for x in params), C, N, T, k_max, n_svc, int(has_shared),
        n_bins if need_hist else 0, log_lo, scale, dev.index or 0, stream)
    build.check(lib, status, "cell_update kernel launch")
    cell_update_cuda.launches += 1
    hist_o = hist
    if need_hist:
        hist_o = hist_accum_cuda(
            bins, hist.clone(memory_format=torch.contiguous_format))
    return free_o, ssum_o, comp_o, cnt_o, hist_o


cell_update_cuda.launches = 0

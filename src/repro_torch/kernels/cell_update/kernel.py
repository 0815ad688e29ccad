"""ctypes wrapper of the CUDA ``cell_update`` kernel
(``repro_torch/csrc/cell_update.cu``) and its launch plan.

The library is built by ``repro_torch.kernels.build`` the first time the
kernel is launched, never when this module is imported.
``cell_update_cuda.launches`` counts launches of the kernel. With the
sketch on, the same launch bins every step's response and adds the counts
into ``hist``: the main path launches nothing else.

``launch_plan`` picks, from the chunk's shape, the kernel's template (the
smallest of ``K_TEMPLATES`` that holds ``k_max``), the cells per block,
the tile of steps the producers stage at a time and the number of
prepared stages, so that the block's shared memory (``smem_bytes``, the
layout of ``make_layout`` in the source) fits. A shape that fits at no
choice raises; there is no other path. Before a launch the wrapper holds
the plan's count to the library's own (``library_smem_bytes``) and raises
where they differ.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hist_sketch import ops as hist_ops

# constants of cell_update.cu (tests/test_torch_kernel_plans.py holds them
# to the source)
MAX_K = 16                  # kMaxK
MAX_SERVERS = 16_384        # kMaxServers
MAX_CELLS = 32              # kMaxCells: one cell per lane
PRODUCERS = 4               # kProducers
THREADS = 32 * (3 + PRODUCERS)  # kThreads
MAX_STAGES = 8              # kMaxStages
FLUSH_STEPS = 8192          # kFlushSteps
MAX_SMEM_BYTES = 232_448    # kMaxSmem
STATIC_SMEM_BYTES = 1024    # kStaticSmem
K_TEMPLATES = (1, 2, 3, 4, 8, 16)
TILES = (64, 32, 16)
STAGES = (MAX_STAGES, 4)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _align16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(*, cells: int, tile: int, stages: int, n_servers: int,
               k_template: int, k_max: int, n_svc: int, n_bins: int,
               seed_rows: int, svc_rows: int, timed: bool) -> int:
    """Dynamic shared memory of one block, as ``make_layout`` in
    ``cell_update.cu`` lays it out: the free-time grid (and a row for the
    template's unused copies), the 16-bit histogram counters, ``stages``
    prepared slots and two raw input buffers per producer, each of
    ``tile`` steps (the block's distinct seed and service rows, at most
    ``seed_rows`` and ``svc_rows``)."""
    G, TS, K = cells, tile, k_template
    grid = _align16((n_servers + 1) * G * 4)
    hist = _align16((n_bins + 1) // 2 * G * 4)
    slot = (2 * _align16(TS * G * 4) + _align16(TS * K * G * 4)
            + (_align16(TS * K * G * 4) if timed else 0)
            + _align16(TS * K * G * 4) + _align16(TS * 4))
    raw = (_align16(seed_rows * TS * 4) + _align16(seed_rows * TS * k_max * 4)
           + _align16(svc_rows * TS * n_svc * 4) + 2 * _align16(TS * 4))
    return grid + hist + stages * slot + 2 * PRODUCERS * raw


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    k_template: int   # K of cell_update_kernel<K, timed>
    cells: int        # G, cells per block
    tile: int         # TS, steps per staged tile
    stages: int       # Q, prepared slots in the ring
    smem_bytes: int   # dynamic shared memory per block
    blocks: int


def launch_plan(*, n_cells: int, n_servers: int, k_max: int, n_svc: int,
                n_bins: int, n_steps: int, seed_rows: int, svc_rows: int,
                timed: bool) -> LaunchPlan:
    """The launch of one chunk (see the module note). Prefers more cells
    per block, then longer tiles (none much longer than the chunk), then
    more stages; raises ValueError when nothing fits the shared memory a
    block may use."""
    if not 1 <= k_max <= min(MAX_K, n_servers):
        raise ValueError(f"k_max={k_max} must be in [1, min({MAX_K}, "
                         f"N={n_servers})]")
    if not 1 <= n_servers <= MAX_SERVERS:
        raise ValueError(f"n_servers={n_servers} must be in [1, "
                         f"{MAX_SERVERS}]")
    if n_cells < 1 or n_steps < 1 or n_bins < 0:
        raise ValueError(f"empty chunk: {n_cells} cells, {n_steps} steps, "
                         f"{n_bins} bins")
    K = next(k for k in K_TEMPLATES if k >= k_max)
    budget = MAX_SMEM_BYTES - STATIC_SMEM_BYTES
    top = min(MAX_CELLS, n_cells)
    for G in [top] + [g for g in (16, 8, 4, 2, 1) if g < top]:
        for TS in [t for t in TILES if t < n_steps + TILES[-1]]:
            for Q in STAGES:
                need = smem_bytes(
                    cells=G, tile=TS, stages=Q, n_servers=n_servers,
                    k_template=K, k_max=k_max, n_svc=n_svc, n_bins=n_bins,
                    seed_rows=min(G, seed_rows), svc_rows=min(G, svc_rows),
                    timed=timed)
                if need <= budget:
                    return LaunchPlan(K, G, TS, Q, need, -(-n_cells // G))
    raise ValueError(
        f"no cell_update launch fits {budget} bytes of shared memory: "
        f"N={n_servers}, k_max={k_max}, n_svc={n_svc}, n_bins={n_bins}")


def _lib() -> ctypes.CDLL:
    lib = build.load("cell_update")
    lib.cell_update_launch.restype = _I
    lib.cell_update_launch.argtypes = ([_VP] * 22 + [_I] * 10 + [_F, _F]
                                       + [_I] * 5 + [_VP])
    lib.cell_update_smem.restype = _I
    lib.cell_update_smem.argtypes = [_I] * 11
    return lib


@functools.lru_cache(maxsize=None)
def library_smem_bytes(plan: LaunchPlan, *, n_servers: int, k_max: int,
                       n_svc: int, n_bins: int, seed_rows: int,
                       svc_rows: int, timed: bool) -> int:
    """``plan``'s dynamic shared memory as the library lays it out
    (``cell_update_smem``, from ``make_layout``), for the shape the plan
    was made for; builds the library if needed."""
    return _lib().cell_update_smem(
        plan.cells, plan.tile, plan.stages, n_servers, plan.k_template,
        k_max, n_svc, n_bins, min(plan.cells, seed_rows),
        min(plan.cells, svc_rows), int(timed))


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
                     has_timed: bool = False, has_dists: bool = False,
                     k_count=None):
    """Kernel twin of ``ref.cell_update_ref`` (same arguments, same bits,
    no ``block`` staging): validates the layout, plans the launch,
    allocates the outputs and launches on the current stream. ``k_mask``
    rows must be prefix masks; they travel as per-cell copy counts,
    ``k_count`` (C,) int32 when the caller has them (the engine does),
    else ``prefix_counts``. ``has_timed`` must be True when any cell has a
    timed policy (the kernel traps otherwise). Index and code tensors of
    another integer dtype are cast to int32."""
    dev = free.device
    if dev.type != "cuda":
        raise ValueError(f"cell_update_cuda needs CUDA tensors, got {dev}")
    C, N = free.shape
    S, T = cum.shape
    k_max = k_mask.shape[1]
    n_svc = services.shape[-1]
    need_hist = hist.numel() > 0
    if n_svc < k_max + int(has_shared):
        raise ValueError(f"services has {n_svc} columns, needs at least "
                         f"{k_max + int(has_shared)}")
    shape = dict(n_servers=N, k_max=k_max, n_svc=n_svc,
                 n_bins=n_bins if need_hist else 0, seed_rows=S,
                 svc_rows=services.shape[0], timed=has_timed)
    plan = launch_plan(n_cells=C, n_steps=T, **shape)
    lib_smem = library_smem_bytes(plan, **shape)
    if lib_smem != plan.smem_bytes:
        raise RuntimeError(f"the launch plan counts {plan.smem_bytes} bytes of "
                           f"shared memory where the library lays out "
                           f"{lib_smem}: {plan}, {shape}")
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
    hist_o = hist.clone(memory_format=torch.contiguous_format) \
        if need_hist else hist
    cum, warm, valid, servers, services = (
        x.contiguous() for x in (cum, warm, valid, servers, services))
    log_lo, scale = hist_ops.log_scale(n_bins) if need_hist else (0.0, 0.0)

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.cell_update_launch(
        ptr(free_o), ptr(ssum_o), ptr(comp_o), ptr(cnt_o),
        ptr(hist_o) if need_hist else None,
        ptr(cum), ptr(warm), ptr(valid), ptr(servers), ptr(services),
        *(ptr(x) for x in params), C, N, T, k_max, n_svc, int(has_shared),
        int(has_timed), n_bins if need_hist else 0, S, services.shape[0],
        log_lo, scale, plan.k_template, plan.cells, plan.tile, plan.stages,
        dev.index or 0, stream)
    build.check(lib, status, "cell_update kernel launch")
    cell_update_cuda.launches += 1
    return free_o, ssum_o, comp_o, cnt_o, hist_o


cell_update_cuda.launches = 0

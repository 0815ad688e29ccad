"""ctypes wrapper of the CUDA ``hist_accum`` kernel
(``repro_torch/csrc/hist_sketch.cu``) and its launch plan.

The library is built by ``repro_torch.kernels.build`` the first time a
kernel is launched, never when this module is imported.
``hist_accum_cuda.launches`` counts the launches of the kernel.

``launch_plan`` cuts the (T, C) indices into CTAs from the shape and the
card's SM count: G cells a CTA, the widest of 8, 4 and 2 that still gives
two groups an SM (one where the cells are fewer), 16-byte loads where C
allows them; where the groups leave SMs idle, the steps of one group are
split over a thread-block cluster of K CTAs (and over several clusters
along T where 8 are not enough), so that the grid holds at least one CTA
an SM. ``bin_share`` is how a cluster's CTAs split the group's bins when
they sum their shared histograms. The launcher checks the plan and raises
where the card refuses it; there is no other path.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build

# constants of hist_sketch.cu (tests/test_torch_kernel_plans.py holds them
# to the source)
THREADS = 256               # kThreads
UNROLL = 4                  # kUnroll: loads in flight a thread
MAX_GROUP = 8               # kMaxGroup: cells a CTA
MAX_CLUSTER = 8             # kMaxCluster: the portable cluster size
MAX_SMEM_BYTES = 232_448    # kMaxSmem
MAX_GROUPS = 65_535         # kMaxGroups: grid.y
# one cell's int32 histogram must fit the shared memory of a CTA
MAX_BINS = MAX_SMEM_BYTES // 4
GROUPS = (8, 4, 2, 1)       # cells a CTA, widest first

_VP, _I = ctypes.c_void_p, ctypes.c_int


def hist_words(cells: int, n_bins: int) -> int:
    """Ints of a CTA's shared histogram, padded to 16-byte words."""
    return (cells * n_bins + 3) & ~3


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    cells: int        # G, cells a CTA
    vec: int          # V, cells a load: 4 (16 bytes) or 1
    cluster: int      # K, CTAs of a cluster, splitting one group's steps
    clusters_t: int   # clusters along T (> 1: they add into out atomically)
    slice: int        # S, steps a CTA
    groups: int       # ceil(C / G)

    @property
    def ctas(self) -> int:
        return self.groups * self.cluster * self.clusters_t


def launch_plan(n_steps: int, n_cells: int, n_bins: int, n_sm: int,
                aligned: bool = True) -> LaunchPlan:
    """The launch of ``hist_accum`` over (``n_steps``, ``n_cells``) indices
    into ``n_bins`` bins on a card of ``n_sm`` SMs (see the module note).
    ``aligned``: the indices start on a 16-byte boundary. Raises
    ValueError for what no launch takes."""
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins} must be in [1, {MAX_BINS}] (one "
                         f"cell's histogram lives in shared memory)")
    if n_steps < 1 or n_cells < 1 or n_sm < 1:
        raise ValueError(f"empty launch: {n_steps} steps, {n_cells} cells, "
                         f"{n_sm} SMs")
    # the widest group that fits and leaves two groups an SM, else one cell
    fits = [g for g in GROUPS if 4 * hist_words(g, n_bins) <= MAX_SMEM_BYTES]
    cells = next((g for g in fits if -(-n_cells // g) >= 2 * n_sm), 1)
    vec = 4 if aligned and cells % 4 == 0 and n_cells % 4 == 0 else 1
    groups = -(-n_cells // cells)
    if groups > MAX_GROUPS:
        raise ValueError(f"{n_cells} cells make {groups} groups of {cells}; "
                         f"the grid holds {MAX_GROUPS}")
    # CTAs along T: enough for one CTA an SM
    n_t = min(n_steps, -(-n_sm // groups))
    clusters_t = -(-n_t // MAX_CLUSTER)
    cluster = 1 << (-(-n_t // clusters_t) - 1).bit_length()
    return LaunchPlan(cells, vec, cluster, clusters_t,
                      -(-n_steps // (cluster * clusters_t)), groups)


def bin_share(rank: int, cluster: int, cells: int,
              n_bins: int) -> tuple[int, int]:
    """[lo, hi) of the ``cells * n_bins`` bins of a group (its live cells)
    that the cluster's CTA ``rank`` sums and writes: shares of a multiple
    of 4 bins (16-byte reads), in rank order."""
    total = cells * n_bins
    per = -(-total // (4 * cluster)) * 4
    lo = min(total, rank * per)
    return lo, min(total, lo + per)


def _lib() -> ctypes.CDLL:
    lib = build.load("hist_sketch")
    for fn in (lib.hist_accum_launch, lib.hist_accum_empty_launch):
        fn.restype = _I
    lib.hist_accum_launch.argtypes = [_VP, _VP] + [_I] * 9 + [_VP]
    lib.hist_accum_empty_launch.argtypes = [_VP] + [_I] * 9 + [_VP]
    return lib


def device_plan(idx: torch.Tensor, n_bins: int) -> LaunchPlan:
    """The plan of ``idx`` (T, C) on its card."""
    t, c = idx.shape
    n_sm = torch.cuda.get_device_properties(idx.device).multi_processor_count
    return launch_plan(t, c, n_bins, n_sm, aligned=idx.data_ptr() % 16 == 0)


def _plan_args(plan: LaunchPlan) -> tuple[int, ...]:
    return (plan.cells, plan.vec, plan.cluster, plan.clusters_t, plan.slice)


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
    plan = device_plan(idx, n_bins)
    lib = _lib()
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    status = lib.hist_accum_launch(idx.data_ptr(), out.data_ptr(), t, c,
                                   n_bins, *_plan_args(plan),
                                   idx.device.index or 0, stream)
    build.check(lib, status, f"hist_accum kernel launch ({plan})")
    hist_accum_cuda.launches += 1
    return out


hist_accum_cuda.launches = 0


def empty_launch(idx: torch.Tensor, n_bins: int) -> None:
    """Launch an empty kernel on the grid, clusters and shared memory of
    ``idx``'s plan: a launch's floor beside ``hist_accum_cuda``, for the
    benchmarks. Counts no launch of the kernel."""
    t, c = idx.shape
    plan = device_plan(idx, n_bins)
    lib = _lib()
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    status = lib.hist_accum_empty_launch(idx.data_ptr(), t, c, n_bins,
                                         *_plan_args(plan),
                                         idx.device.index or 0, stream)
    build.check(lib, status, "hist_accum empty launch")

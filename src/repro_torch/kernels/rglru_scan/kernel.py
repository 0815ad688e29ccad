"""ctypes wrapper of the CUDA ``rglru_scan`` kernel
(``repro_torch/csrc/rglru_scan.cu``) and its launch plan.

The library is built by ``repro_torch.kernels.build`` the first time the
kernel is launched, never when this module is imported.
``linear_scan_cuda.launches`` counts launches of the kernel.

``launch_plan`` picks, from the shape, the kernel and the stages of its
ring: a sequence of more than ``TILE`` steps goes through the ring
(``MAX_STAGES`` stages, or fewer where the sequence has fewer tiles), one
of ``TILE`` steps or fewer through the direct kernel (stages 0, no shared
memory), since nothing would overlap the ring's round trip there. Both
take one CTA per (strip of ``LANES`` lanes, batch row), decoded by
``cta_work`` as the kernels decode it. The ring moves its tiles with the
TMA, whose rows must be multiples of 16 bytes, so the width must be a
multiple of 4; the plan raises otherwise. Before a launch the wrapper
holds the plan's shared memory to the library's own
(``library_smem_bytes``) and raises where they differ.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.kernel import check_f32

# constants of rglru_scan.cu (tests/test_torch_recurrent_plans.py holds them
# to the source)
LANES = 32                # kLanes
THREADS = 64              # kThreads: a producer warp, a consumer warp
TILE = 64                 # kTile: steps a stage of the ring holds
MAX_STAGES = 4            # kMaxStages
MAX_SMEM_BYTES = 232_448  # kMaxSmem

_VP, _I = ctypes.c_void_p, ctypes.c_int
# replicas launch from their own threads; the count's += is not atomic
_COUNT_LOCK = threading.Lock()


def smem_bytes(stages: int) -> int:
    """Dynamic shared memory of a CTA, as ``layout_bytes`` in
    ``rglru_scan.cu`` lays it out: ``stages`` pairs of (a, b) tiles of
    ``TILE`` steps x ``LANES`` floats, two tiles of h on their way out,
    then a full and an empty mbarrier per stage; none for the direct
    kernel (stages 0)."""
    if stages == 0:
        return 0
    return (stages + 1) * 2 * TILE * LANES * 4 + 2 * stages * 8


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    stages: int      # stages of the ring; 0: the direct kernel
    time_tiles: int  # tiles of TILE steps, the last one partial
    strips: int      # of LANES lanes per batch row
    blocks: int      # strips x batch rows
    threads: int     # per CTA: THREADS for the ring, LANES direct
    smem_bytes: int


def launch_plan(batch: int, length: int, width: int) -> LaunchPlan:
    """The launch at a/b (B, L, W) (see the module note); raises
    ValueError on an empty shape, a width that is not a multiple of 4 or a
    grid too large."""
    if min(batch, length, width) < 1:
        raise ValueError(f"empty rglru_scan shape: B={batch}, L={length}, "
                         f"W={width}")
    if width % 4:
        raise ValueError(f"rglru_scan needs a width that is a multiple of 4 "
                         f"(16-byte rows for the TMA), got W={width}")
    n_tiles = -(-length // TILE)
    stages = 0 if n_tiles == 1 else min(MAX_STAGES, n_tiles)
    strips = -(-width // LANES)
    blocks = strips * batch
    if blocks > 2**31 - 1:
        raise ValueError(f"rglru_scan grid of {blocks} blocks is too large")
    return LaunchPlan(stages, n_tiles, strips, blocks,
                      THREADS if stages else LANES, smem_bytes(stages))


def cta_work(plan: LaunchPlan, block: int, width: int):
    """What block ``block`` of ``plan`` computes, decoded as the kernel
    decodes ``blockIdx.x``: its (batch row, lane, time tile) triples."""
    strip, bi = block % plan.strips, block // plan.strips
    w0 = strip * LANES
    return [(bi, w, k) for w in range(w0, min(w0 + LANES, width))
            for k in range(plan.time_tiles)]


def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    lib.rglru_scan_launch.restype = _I
    lib.rglru_scan_launch.argtypes = [_VP] * 3 + [_I] * 5 + [_VP]
    lib.rglru_scan_smem.restype = _I
    lib.rglru_scan_smem.argtypes = [_I]
    return lib


@functools.lru_cache(maxsize=None)
def library_smem_bytes(stages: int) -> int:
    """A CTA's dynamic shared memory as the library lays it out
    (``rglru_scan_smem``); builds the library if needed."""
    return _lib().rglru_scan_smem(stages)


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
    plan = launch_plan(bsz, length, width)
    lib_smem = library_smem_bytes(plan.stages)
    if lib_smem != plan.smem_bytes:
        raise RuntimeError(f"the launch plan counts {plan.smem_bytes} bytes of "
                           f"shared memory where the library lays out "
                           f"{lib_smem}: {plan}")
    # the TMA reads and writes 16-byte aligned rows (a view may start
    # elsewhere; torch's own allocations are aligned)
    a, b = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (a, b))
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                   bsz, length, width, plan.stages,
                                   dev.index or 0, stream)
    build.check(lib, status, "rglru_scan kernel launch")
    with _COUNT_LOCK:
        linear_scan_cuda.launches += 1
    return h


linear_scan_cuda.launches = 0

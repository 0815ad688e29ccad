"""ctypes wrapper of the CUDA ``ssd_scan`` kernel
(``repro_torch/csrc/ssd_scan.cu``: the intra-chunk output and the chunk
states in one launch, split-TF32 products on the tensor cores) and its
launch plan.

The library is built by ``repro_torch.kernels.build`` the first time the
kernel is launched, never when this module is imported.
``ssd_intra_chunk_cuda.launches`` counts launches of the kernel.

``launch_plan`` picks, from the shape and the card's SM count, how many
heads a y CTA takes (they share its C B^T tiles): the most of
``HEAD_GROUPS`` that still gives at least two y CTAs an SM, so that one
chunk (a served prompt) fills the card as 16 chunks do. It counts the
grid (y CTAs, heaviest query tiles first, then state CTAs; ``cta_work``
decodes a block index as the kernel does) and the shared memory
(``smem_bytes``, the layout of ``make_layout`` in the source). A shape
that fits nowhere raises; there is no other path. Before a launch the
wrapper holds the plan's count to the library's own
(``library_smem_bytes``) and raises where they differ.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from repro_torch.kernels import build

# constants of ssd_scan.cu (tests/test_torch_recurrent_plans.py holds them
# to the source)
TILE = 64             # kTile: query rows of a y CTA, rows of a key tile
WARPS = 4             # kWarps
THREADS = 128         # kThreads
SLICE = 32            # kSlice: d_state columns per G stage
STAGES = 2            # kStages
MAX_P, MAX_N = 128, 256   # kMaxP, kMaxN
STATE_P, STATE_N = 64, 128  # kStateP, kStateN: a state CTA's block
STATE_Q = 16          # kStateQ: chunk rows per state stage
STATE_STAGES = 4      # kStateStages
MAX_SMEM_BYTES = 232_448  # kMaxSmem
HEAD_GROUPS = (8, 4, 2, 1)

_VP, _I = ctypes.c_void_p, ctypes.c_int
# replicas launch from their own threads; the count's += is not atomic
_COUNT_LOCK = threading.Lock()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def smem_bytes(q: int, p: int) -> int:
    """Dynamic shared memory of a CTA, as ``make_layout`` in
    ``ssd_scan.cu`` lays it out: for a y CTA the G tiles of one query
    tile, then ``STAGES`` stages, each the larger of a G stage (C and B
    slices) and a W X stage (the X rows of a key tile, cum and dt); for a
    state CTA ``STATE_STAGES`` stages of X and B slices, cum, dt and the
    gate. The launch gives every CTA the larger."""
    ldx = _round_up(p, 8) + 4
    g_stage = 2 * TILE * (SLICE + 4)
    x_stage = TILE * ldx + 2 * TILE
    s_stage = STATE_Q * (STATE_P + 8 + STATE_N + 8) + 3 * STATE_Q
    stage = _round_up(max(g_stage, x_stage), 4)
    g_floats = _cdiv(q, TILE) * TILE * TILE
    return 4 * max(g_floats + STAGES * stage, STATE_STAGES * s_stage)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    heads_per_cta: int  # HG: heads of a y CTA, sharing its C B^T
    query_tiles: int    # of TILE rows per chunk
    head_groups: int
    y_blocks: int       # chunks x query tiles x head groups
    state_blocks: int   # chunks x heads x P blocks x N blocks
    blocks: int
    smem_bytes: int


def launch_plan(bc: int, q: int, h: int, p: int, n: int,
                n_sms: int) -> LaunchPlan:
    """The launch of one call at x (BC, Q, H, P), b/c (BC, Q, N) on a card
    of ``n_sms`` SMs (see the module note); raises ValueError on what the
    kernel does not take."""
    if min(bc, q, h, p, n) < 1 or n_sms < 1:
        raise ValueError(f"empty ssd_scan shape: BC={bc}, Q={q}, H={h}, "
                         f"P={p}, N={n}, {n_sms} SMs")
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"head_dim P={p} must be at most {MAX_P} and "
                         f"d_state N={n} at most {MAX_N}")
    need = smem_bytes(q, p)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan at chunk Q={q}, P={p} needs {need} bytes "
                         f"of shared memory, more than {MAX_SMEM_BYTES}")
    n_qt = _cdiv(q, TILE)
    hg = next((g for g in HEAD_GROUPS
               if g <= h and bc * n_qt * _cdiv(h, g) >= 2 * n_sms), 1)
    y = bc * n_qt * _cdiv(h, hg)
    state = bc * h * _cdiv(p, STATE_P) * _cdiv(n, STATE_N)
    if y + state > 2**31 - 1:
        raise ValueError(f"ssd_scan grid of {y + state} blocks is too large")
    return LaunchPlan(hg, n_qt, _cdiv(h, hg), y, state, y + state, need)


def cta_work(plan: LaunchPlan, block: int, *, h: int, p: int, n: int):
    """What block ``block`` of ``plan`` computes, decoded as the kernel
    decodes ``blockIdx.x``: ``("y", chunk, query tile, heads)`` or
    ``("state", chunk, head, P block, N block)``."""
    if block < plan.y_blocks:
        per_qt = plan.y_blocks // plan.query_tiles
        qt = plan.query_tiles - 1 - block // per_qt
        hg, chunk = block % per_qt % plan.head_groups, \
            block % per_qt // plan.head_groups
        h0 = hg * plan.heads_per_cta
        return ("y", chunk, qt, tuple(range(h0, min(h0 + plan.heads_per_cta,
                                                    h))))
    i = block - plan.y_blocks
    n_pb, n_nb = _cdiv(p, STATE_P), _cdiv(n, STATE_N)
    blk, hc = i % (n_pb * n_nb), i // (n_pb * n_nb)
    return ("state", hc // h, hc % h, blk % n_pb, blk // n_pb)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan_launch.restype = _I
    lib.ssd_scan_launch.argtypes = [_VP] * 7 + [_I] * 7 + [_VP]
    lib.ssd_scan_smem.restype = _I
    lib.ssd_scan_smem.argtypes = [_I, _I]
    return lib


@functools.lru_cache(maxsize=None)
def library_smem_bytes(q: int, p: int) -> int:
    """A CTA's dynamic shared memory as the library lays it out
    (``ssd_scan_smem``, from ``make_layout``); builds the library if
    needed."""
    return _lib().ssd_scan_smem(q, p)


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
    H, P) and states (B, NC, H, P, N), computed in one launch on the
    current stream."""
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
    index = dev.index or 0
    plan = launch_plan(b * nc, q, h, p, n, _sm_count(index))
    lib_smem = library_smem_bytes(q, p)
    if lib_smem != plan.smem_bytes:
        raise RuntimeError(f"the launch plan counts {plan.smem_bytes} bytes of "
                           f"shared memory where the library lays out "
                           f"{lib_smem}: {plan}")
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.ssd_scan_launch(
        xc.data_ptr(), bc.data_ptr(), cc.data_ptr(), dtc.data_ptr(),
        cum.data_ptr(), y.data_ptr(), states.data_ptr(), b * nc, q, h, p, n,
        plan.heads_per_cta, index, stream)
    build.check(lib, status, "ssd_scan kernel launch")
    with _COUNT_LOCK:
        ssd_intra_chunk_cuda.launches += 1
    return y, states


ssd_intra_chunk_cuda.launches = 0

"""Host-side plans of the recurrent kernels, on the CPU: the launch plans of
``ssd_scan`` (heads per y CTA, grid, shared memory) and ``rglru_scan``
(time tile, stages, grid, shared memory) against the constants of their
sources, and an emulation of ``ssd_scan``'s split-TF32 products that pins
why the kernel splits its operands and where its distance from float64
comes from (``python tests/test_torch_recurrent_plans.py`` prints those
distances, and on a card the kernel's beside them). The kernels themselves
run only on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``)."""
import collections
import itertools
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref

H100_SMS = 132
SSD_TOL = 5e-3  # tests/test_kernels.py: |err| <= 5e-3 + 5e-3 |plain|


def _cu_constant(source: str, name: str) -> int:
    text = (build.CSRC / f"{source}.cu").read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    value = m.group(1).split("//")[0].strip()
    if value.isdigit():
        return int(value)
    names = set(re.findall(r"[A-Za-z_]\w*", value))
    return eval(value, {}, {n: _cu_constant(source, n) for n in names})


def test_ssd_constants_match_the_source():
    for name, value in (("kTile", ssd_kernel.TILE),
                        ("kWarps", ssd_kernel.WARPS),
                        ("kThreads", ssd_kernel.THREADS),
                        ("kSlice", ssd_kernel.SLICE),
                        ("kStages", ssd_kernel.STAGES),
                        ("kMaxP", ssd_kernel.MAX_P),
                        ("kMaxN", ssd_kernel.MAX_N),
                        ("kStateP", ssd_kernel.STATE_P),
                        ("kStateN", ssd_kernel.STATE_N),
                        ("kStateQ", ssd_kernel.STATE_Q),
                        ("kStateStages", ssd_kernel.STATE_STAGES),
                        ("kMaxSmem", ssd_kernel.MAX_SMEM_BYTES)):
        assert _cu_constant("ssd_scan", name) == value, name
    # a y warp owns one m16 block of the query tile; a state CTA's four
    # warps own 32 x 64 each of its block
    assert ssd_kernel.TILE == 16 * ssd_kernel.WARPS
    assert ssd_kernel.STATE_P * ssd_kernel.STATE_N == \
        ssd_kernel.WARPS * 32 * 64
    assert ssd_kernel.SLICE % 8 == 0 and ssd_kernel.STATE_Q % 8 == 0


def test_rglru_constants_match_the_source():
    for name, value in (("kLanes", scan_kernel.LANES),
                        ("kThreads", scan_kernel.THREADS),
                        ("kTile", scan_kernel.TILE),
                        ("kMaxStages", scan_kernel.MAX_STAGES),
                        ("kMaxSmem", scan_kernel.MAX_SMEM_BYTES)):
        assert _cu_constant("rglru_scan", name) == value, name
    text = (build.CSRC / "rglru_scan.cu").read_text()
    # the launcher takes the direct kernel exactly where the plan does
    assert "(stages == 0) != (L <= kTile)" in text
    assert scan_kernel.THREADS == 2 * scan_kernel.LANES


SSD_SHAPES = [
    # (BC, Q, H, P, N, SMs)
    (16, 256, 32, 64, 128, H100_SMS),  # mamba2-370m's prefill of 4096
    (1, 256, 32, 64, 128, H100_SMS),   # a served prompt: one padded chunk
    (1, 1, 4, 16, 8, H100_SMS),
    (3, 63, 3, 24, 40, H100_SMS),
    (2, 65, 5, 64, 128, H100_SMS),
    (2, 100, 6, 128, 256, H100_SMS),
    (1, 256, 32, 128, 256, H100_SMS),
    (16, 256, 4, 64, 128, H100_SMS),
    (2, 50, 3, 10, 13, H100_SMS),
    (5, 640, 7, 33, 129, 8),
]


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_plan_covers_every_tile_once_and_fits(shape):
    bc, q, h, p, n, n_sms = shape
    plan = ssd_kernel.launch_plan(bc, q, h, p, n, n_sms)
    assert plan.smem_bytes == ssd_kernel.smem_bytes(q, p) <= \
        ssd_kernel.MAX_SMEM_BYTES
    assert plan.blocks == plan.y_blocks + plan.state_blocks
    seen = collections.Counter()
    for block in range(plan.blocks):
        work = ssd_kernel.cta_work(plan, block, h=h, p=p, n=n)
        if work[0] == "y":
            _, chunk, qt, heads = work
            assert 1 <= len(heads) <= plan.heads_per_cta
            seen.update(("y", chunk, qt, hh) for hh in heads)
        else:
            seen[work] += 1
    n_qt = -(-q // ssd_kernel.TILE)
    want = ({("y", c, t, hh) for c in range(bc) for t in range(n_qt)
             for hh in range(h)}
            | {("state", c, hh, pb, nb) for c in range(bc) for hh in range(h)
               for pb in range(-(-p // ssd_kernel.STATE_P))
               for nb in range(-(-n // ssd_kernel.STATE_N))})
    assert set(seen) == want
    assert set(seen.values()) == {1}
    # the heaviest query tiles come first
    qts = [ssd_kernel.cta_work(plan, i, h=h, p=p, n=n)[2]
           for i in range(plan.y_blocks)]
    assert qts == sorted(qts, reverse=True)


def test_ssd_plan_of_the_main_path():
    # 16 chunks: four heads share a y CTA's C B^T; two CTAs fit an SM
    plan = ssd_kernel.launch_plan(16, 256, 32, 64, 128, H100_SMS)
    assert (plan.heads_per_cta, plan.y_blocks, plan.state_blocks) == \
        (4, 512, 512)
    assert 2 * (plan.smem_bytes + 1024) <= 233_472
    # one chunk (a served prompt): a head a CTA, 4 x 32 y CTAs
    plan = ssd_kernel.launch_plan(1, 256, 32, 64, 128, H100_SMS)
    assert (plan.heads_per_cta, plan.y_blocks, plan.state_blocks) == \
        (1, 128, 32)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_plan_takes_the_most_heads_that_fill_the_card(shape):
    bc, q, h, p, n, n_sms = shape
    plan = ssd_kernel.launch_plan(bc, q, h, p, n, n_sms)
    n_qt = -(-q // ssd_kernel.TILE)

    def y_blocks(g):
        return bc * n_qt * -(-h // g)

    assert plan.y_blocks == y_blocks(plan.heads_per_cta)
    if plan.heads_per_cta > 1:
        assert plan.y_blocks >= 2 * n_sms
    bigger = [g for g in ssd_kernel.HEAD_GROUPS
              if plan.heads_per_cta < g <= h]
    assert all(y_blocks(g) < 2 * n_sms for g in bigger)


@pytest.mark.parametrize("shape", [
    (1, 256, 32, 129, 128),  # P past kMaxP
    (1, 256, 32, 64, 257),   # N past kMaxN
    (1, 4096, 32, 64, 128),  # a chunk whose G tiles overflow the block
    (1, 768, 32, 128, 128),
    (0, 256, 32, 64, 128),
    (1, 0, 32, 64, 128),
    (1, 256, 0, 64, 128),
])
def test_ssd_plan_rejects_what_does_not_fit(shape):
    with pytest.raises(ValueError):
        ssd_kernel.launch_plan(*shape, H100_SMS)


def test_ssd_plan_rejects_a_card_without_sms():
    with pytest.raises(ValueError):
        ssd_kernel.launch_plan(1, 256, 32, 64, 128, 0)


SCAN_SHAPES = [
    # (B, L, W)
    (1, 4096, 4096),  # chip_smoke.py's table shape
    (1, 16, 4096),    # recurrentgemma-9b's served prompts
    (1, 2560, 4096),  # its prefill past the window
    (1, 2573, 4096), (2, 77, 4096), (1, 1, 4096), (2, 63, 96),
    (3, 65, 40), (3, 5, 40), (3, 256, 12), (2, 129, 4096), (1, 64, 4096),
]


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_rglru_plan_covers_every_lane_and_tile_once_and_fits(shape):
    batch, length, width = shape
    plan = scan_kernel.launch_plan(batch, length, width)
    tile = scan_kernel.TILE
    if length <= tile:  # the direct kernel: no ring
        assert (plan.stages, plan.threads) == (0, scan_kernel.LANES)
    else:
        assert 1 <= plan.stages <= min(scan_kernel.MAX_STAGES,
                                       plan.time_tiles)
        assert plan.threads == scan_kernel.THREADS
    assert tile * (plan.time_tiles - 1) < length <= tile * plan.time_tiles
    assert plan.smem_bytes == scan_kernel.smem_bytes(plan.stages)
    assert plan.smem_bytes <= scan_kernel.MAX_SMEM_BYTES
    seen = collections.Counter()
    for block in range(plan.blocks):
        seen.update(scan_kernel.cta_work(plan, block, width))
    assert set(seen) == set(itertools.product(
        range(batch), range(width), range(plan.time_tiles)))
    assert set(seen.values()) == {1}


def test_rglru_plan_of_the_main_path_keeps_megabytes_in_flight():
    plan = scan_kernel.launch_plan(1, 4096, 4096)
    assert (plan.stages, plan.blocks) == (4, 128)
    in_flight = (plan.blocks * plan.stages * scan_kernel.TILE
                 * scan_kernel.LANES * 8)
    assert in_flight >= 4 * 2**20
    # a served prompt (16 steps) goes to the direct kernel, the same grid
    plan = scan_kernel.launch_plan(1, 16, 4096)
    assert (plan.stages, plan.time_tiles, plan.blocks, plan.smem_bytes) == \
        (0, 1, 128, 0)


@pytest.mark.parametrize("shape", [(0, 16, 4096), (1, 0, 4096), (1, 16, 0),
                                   (1, 16, 13), (2, 77, 4094)])
def test_rglru_plan_rejects_empty_shapes_and_unaligned_rows(shape):
    with pytest.raises(ValueError):
        scan_kernel.launch_plan(*shape)


# ---------------------------------------------------------------------------
# Why ssd_scan splits its operands. An emulation of its arithmetic: each
# product's operands rounded to TF32 as cvt.rna rounds them (10 explicit
# mantissa bits, to nearest, ties away), the products summed in float64;
# the weights and the gate in float32 as the kernel makes them. Split TF32
# (hi + lo, three products) lands far inside the gate of tests/test_kernels.py
# at mamba2-370m's shape with phase 9's standard-normal inputs; one TF32
# pass does not.
# ---------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor,
             split: bool) -> torch.Tensor:
    ah, bh = _tf32(a), _tf32(b)
    terms = [(ah, bh)]
    if split:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        terms += [(al, bh), (ah, bl)]
    return sum(torch.einsum(eq, u.double(), v.double())
               for u, v in terms).float()


def _emulated_kernel(x, b, c, dt, cum, split: bool):
    """One chunk: x (Q, H, P), b/c (Q, N), dt/cum (Q, H)."""
    q = x.shape[0]
    g = _product("qn,sn->qs", c, b, split)
    rel = cum[:, None, :] - cum[None, :, :]
    live = torch.ones((q, q), dtype=torch.bool).tril()[:, :, None]
    w = torch.where(live, g[:, :, None] * torch.exp(rel) * dt[None],
                    torch.zeros(()))
    y = _product("qsh,shp->qhp", w, x, split)
    gate = torch.exp(cum[-1:] - cum) * dt
    states = _product("qhp,qn->hpn", x * gate[:, :, None], b, split)
    return y, states


def _std_normal_chunk():
    """Phase 9's standard-normal inputs at mamba2-370m's shape, one chunk:
    x (Q, H, P), b/c (Q, N), dt/cum (Q, H)."""
    rng = np.random.default_rng(9)
    q, h, p, n = 256, 32, 64, 128  # mamba2-370m: chunk, heads, P, d_state
    f32 = np.float32
    x = rng.standard_normal((q, h, p)).astype(f32)
    b, c = (rng.standard_normal((q, n)).astype(f32) for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((q, h)))).astype(f32)
    a = -np.exp(0.2 * rng.standard_normal(h)).astype(f32)
    cum = np.cumsum(dt * a, axis=0).astype(f32)
    return [torch.from_numpy(v) for v in (x, b, c, dt, cum)]


@pytest.mark.parametrize("split,inside", [(True, True), (False, False)])
def test_split_tf32_meets_the_ssd_gate_and_one_pass_does_not(split, inside):
    x, b, c, dt, cum = _std_normal_chunk()
    want = ssd_intra_chunk_ref(*(v[None, None] for v in (x, b, c, dt, cum)))
    got = _emulated_kernel(x, b, c, dt, cum, split)
    ratio = max(float(((g - w[0, 0]).abs()
                       / (SSD_TOL + SSD_TOL * w[0, 0].abs())).max())
                for g, w in zip(got, want))
    if inside:
        assert ratio < 0.05, ratio
    else:
        assert ratio > 1.0, ratio


# Where the kernel's distance from float64 comes from. The same split, with
# each m16n8k8 mma's eight products summed exactly and added to a float32
# accumulator rounded to nearest ("rn") or toward zero ("rz"), or kept in
# float64 ("f64"), in the kernel's order (per block of eight along the
# reduction: lo.hi, hi.lo, then hi.hi), with or without the lo.lo term that
# the kernel drops. Neither the split nor the dropped term moves y away from
# float64 beyond the plain float32 version's own distance; an accumulator
# that truncates does, by several times.


def _round_f32(x: torch.Tensor, mode: str) -> torch.Tensor:
    f = x.float()
    if mode == "rz":
        f = torch.where(f.double().abs() > x.abs(),
                        torch.nextafter(f, torch.zeros_like(f)), f)
    return f


def _mma_product(a: torch.Tensor, b: torch.Tensor, mode: str,
                 lolo: bool) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) in split TF32, accumulated as the
    module note above says."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    terms = [(al, bh), (ah, bl), (ah, bh)] + ([(al, bl)] if lolo else [])
    d = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    for k0 in range(0, a.shape[-1], 8):
        for u, v in terms:
            d = d + u[..., k0:k0 + 8].double() @ v[..., k0:k0 + 8, :].double()
            if mode != "f64":
                d = _round_f32(d, mode).double()
    return d.float()


def _emulated_accumulation(x, b, c, dt, cum, mode: str, lolo: bool):
    """``_emulated_kernel`` in split TF32 with ``_mma_product``'s
    accumulation."""
    q = x.shape[0]
    g = _mma_product(c, b.T.contiguous(), mode, lolo)
    rel = cum[:, None, :] - cum[None, :, :]
    live = torch.ones((q, q), dtype=torch.bool).tril()[:, :, None]
    w = torch.where(live, g[:, :, None] * torch.exp(rel) * dt[None],
                    torch.zeros(()))
    y = _mma_product(w.permute(2, 0, 1).contiguous(),
                     x.permute(1, 0, 2).contiguous(), mode, lolo)
    gate = torch.exp(cum[-1:] - cum) * dt
    states = _mma_product((x * gate[:, :, None]).permute(1, 2, 0).contiguous(),
                          b, mode, lolo)
    return y.permute(1, 0, 2), states


def _f64_distances(outs, inputs) -> list[float]:
    """Largest |output - float64| of (y, states) for one chunk's outputs."""
    exact = ssd_intra_chunk_ref(*(v.double()[None, None] for v in inputs))
    return [float((o.double() - e[0, 0]).abs().max())
            for o, e in zip(outs, exact)]


ACCUMULATIONS = [("f64", False), ("f64", True), ("rn", False), ("rn", True),
                 ("rz", False), ("rz", True)]


@pytest.mark.parametrize("mode,lolo", ACCUMULATIONS)
def test_split_tf32_distance_from_float64_comes_from_the_accumulator(mode,
                                                                     lolo):
    inputs = _std_normal_chunk()
    plain = ssd_intra_chunk_ref(*(v[None, None] for v in inputs))
    plain_y = _f64_distances([o[0, 0] for o in plain], inputs)[0]
    y = _f64_distances(_emulated_accumulation(*inputs, mode, lolo), inputs)[0]
    if mode == "rz":
        assert y > 2 * plain_y, (y, plain_y)
    else:
        assert y < plain_y, (y, plain_y)


def _chip_smoke():
    import importlib.util
    path = build.PKG_DIR.parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # imports nothing but the standard library
    return mod


def test_planted_faults_edit_their_sources_once():
    # each fault of chip_smoke.py --faults must find its text once in its
    # kernel source, and --gates must run the phases that hold its kernel
    smoke = _chip_smoke()
    for name, (source, old, new, _) in smoke.FAULTS.items():
        text = (build.CSRC / f"{source}.cu").read_text()
        assert text.count(old) == 1 and new != old, name
        assert set(smoke.FAULT_PHASES.get(source, [5, 6, 7])) <= \
            set(smoke.GATE_PHASES), name
    assert smoke.FAULT_PHASES["ssd_scan"] == [9]
    assert smoke.FAULT_PHASES["rglru_scan"] == [11]


if __name__ == "__main__":
    # the distances behind the test above; on a card, the kernel's and the
    # plain version's on the same inputs beside them
    chunk = _std_normal_chunk()
    plain = ssd_intra_chunk_ref(*(v[None, None] for v in chunk))
    print("plain float32 (CPU):", _f64_distances([o[0, 0] for o in plain],
                                                  chunk), "(y, states)")
    for mode, lolo in ACCUMULATIONS:
        print(f"split TF32, accumulator {mode}, lo.lo {lolo}:",
              _f64_distances(_emulated_accumulation(*chunk, mode, lolo),
                             chunk))
    if torch.cuda.is_available():
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        args = [v[None, None].cuda() for v in chunk]
        for kernel in ("on", "off"):
            outs = ssd_ops.ssd_intra_chunk(*args, kernel=kernel)
            print(f"card, kernel={kernel}:",
                  _f64_distances([o[0, 0].cpu() for o in outs], chunk))

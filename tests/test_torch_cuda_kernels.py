"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and ``nvcc`` (marker ``cuda``) and
skips where ``torch.cuda.is_available()`` is False. The file imports no
JAX, so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import distributions as dists
from repro_torch.core import queueing
from repro_torch.core.scenario import (CANCEL_ON_COMPLETE, HEDGE_AFTER_DELAY,
                                       SERVER_DEPENDENT, Degradation,
                                       Scenario)
from repro_torch.kernels.cell_update import kernel as cell_kernel
from repro_torch.kernels.cell_update import ops as cell_ops
from repro_torch.kernels.hist_sketch import ops as hist_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("n_bins", [100, 256, 2048])
def test_hist_accum_kernel_equals_plain(cuda_device, n_bins):
    idx = np.random.default_rng(n_bins).integers(-1, n_bins, (4096, 37))
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda_device)
    got = hist_ops.hist_accum(idx, n_bins=n_bins, kernel="on")
    want = hist_ops.hist_accum(idx, n_bins=n_bins, kernel="off")
    assert torch.equal(got, want)


@pytest.mark.parametrize("arm", list(interop.CELL_UPDATE_ARMS) + [
    "generic_mix"])
def test_cell_update_kernel_bit_equal_plain(cuda_device, arm):
    kw = (dict(k_max=3, policies=(0, 1, 2, 3, 4), models=(0, 1), mix=0.6,
               delay=0.7) if arm == "generic_mix"
          else interop.CELL_UPDATE_ARMS[arm])
    args, static = interop.synthetic_chunk(len(arm), n_cells=64,
                                           n_servers=20, steps=2048, **kw)
    t = [interop.to_tensor(args[k], cuda_device)
         for k in interop.CELL_UPDATE_ARGS]
    before = cell_kernel.cell_update_cuda.launches
    got = cell_ops.cell_update(*t, block=512, kernel="on", **static)
    want = cell_ops.cell_update(*t, block=512, kernel="off", **static)
    assert cell_kernel.cell_update_cuda.launches == before + 1
    for name, g, w in zip(("free", "ssum", "comp", "cnt", "hist"), got,
                          want):
        assert torch.equal(g, w), name


def _cell_kernel_equals_plain(device, seed, steps, **kw):
    """One chunk of ``synthetic_chunk`` through the kernel (one launch) and
    the plain version on the card: every output bit-equal."""
    args, static = interop.synthetic_chunk(seed, steps=steps, **kw)
    t = [interop.to_tensor(args[k], device) for k in interop.CELL_UPDATE_ARGS]
    before = cell_kernel.cell_update_cuda.launches
    got = cell_ops.cell_update(*t, block=steps, kernel="on", **static)
    torch.cuda.synchronize()
    assert cell_kernel.cell_update_cuda.launches == before + 1
    want = cell_ops.cell_update(*t, block=steps, kernel="off", **static)
    for name, g, w in zip(("free", "ssum", "comp", "cnt", "hist"), got,
                          want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("case", list(interop.CELL_UPDATE_EDGES))
def test_cell_update_kernel_edges_bit_equal_plain(cuda_device, case):
    kw = dict(interop.CELL_UPDATE_EDGES[case])
    kw.setdefault("n_servers", 20)
    _cell_kernel_equals_plain(cuda_device, 5, kw.pop("steps"), **kw)


def test_main_path_sketch_launches_cell_update_once_a_chunk(cuda_device):
    from repro_torch.kernels.hist_sketch import kernel as hist_kernel
    d = dists.exponential()
    cfg = queueing.SimConfig(n_servers=20, n_arrivals=4_000)
    kw = dict(n_seeds=2, percentiles=(50.0, 99.0), chunk_size=1500,
              device="cuda")
    cell_kernel.cell_update_cuda.launches = 0
    hist_kernel.hist_accum_cuda.launches = 0
    a = queueing.run(4, Scenario.paper_default(d, ks=(1, 2)), [0.2, 0.4],
                     cfg, kernel="on", **kw)
    assert cell_kernel.cell_update_cuda.launches == 3   # ceil(4000 / 1500)
    assert hist_kernel.hist_accum_cuda.launches == 0
    b = queueing.run(4, Scenario.paper_default(d, ks=(1, 2)), [0.2, 0.4],
                     cfg, kernel="off", **kw)
    for key in ("mean", "completed", "p50", "p99"):
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("timed", (False, True))
def test_cell_plan_smem_equals_the_library_layout(cuda_device, timed):
    # the Python count the launch plan chooses by, against the library's
    # make_layout: at every template, N and bin count of the plan tests,
    # and at every block, tile and stage count the plan weighs
    for K in cell_kernel.K_TEMPLATES:
        for N in (20, 1000, cell_kernel.MAX_SERVERS):
            for n_bins in (0, 100, 2048, 58_112):
                k_max = min(K, N)
                shape = dict(n_servers=N, k_max=k_max, n_svc=2 * k_max + 1,
                             n_bins=n_bins, seed_rows=30, svc_rows=30,
                             timed=timed)
                for g in (32, 16, 8, 4, 2, 1):
                    for ts in cell_kernel.TILES:
                        for q in cell_kernel.STAGES:
                            need = cell_kernel.smem_bytes(
                                cells=g, tile=ts, stages=q, n_servers=N,
                                k_template=K, k_max=k_max,
                                n_svc=2 * k_max + 1, n_bins=n_bins,
                                seed_rows=min(g, 30), svc_rows=min(g, 30),
                                timed=timed)
                            plan = cell_kernel.LaunchPlan(K, g, ts, q, need,
                                                          0)
                            assert cell_kernel.library_smem_bytes(
                                plan, **shape) == need, (plan, shape)


def test_run_with_kernels_equals_plain_run(cuda_device):
    d = dists.pareto(2.2)
    grid = (Scenario.paper_default(d, ks=(1, 2)),
            Scenario(dists=d, policy=CANCEL_ON_COMPLETE, ks=(3,),
                     service_model=SERVER_DEPENDENT, mix=0.4),
            Scenario(dists=d, policy=HEDGE_AFTER_DELAY, delay=0.5, ks=(2,),
                     degradation=Degradation(p_fail=0.05)))
    kw = dict(n_seeds=2, percentiles=(50.0, 99.0), chunk_size=1500,
              device="cuda")
    cfg = queueing.SimConfig(n_servers=20, n_arrivals=4_000)
    a = queueing.run(3, grid, [0.1, 0.3], cfg, kernel="on", **kw)
    b = queueing.run(3, grid, [0.1, 0.3], cfg, kernel="off", **kw)
    for key in ("mean", "completed", "p50", "p99"):
        assert torch.equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# attention kernels. The plain versions round probabilities to bf16 where
# the kernels keep them in float32, so the two agree to a tolerance: in
# every row (query position and head) 2^-6 of the row's largest value (two
# bf16 ulps), which holds where a long flat softmax makes the outputs
# small; with standard-normal inputs also 2e-2 anywhere (the bf16
# tolerance of tests/test_kernels.py). Peaked inputs give outputs up to
# ~4.5, where one bf16 ulp is 0.03125, so they take the row gate only.
# ---------------------------------------------------------------------------

ATTN_TOL = 2e-2
ATTN_REL = 2**-6


def _bf16(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16)


def _assert_attention_close(got, want, absolute=True):
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    assert float(err.max()) <= ATTN_TOL or not absolute
    allow = ATTN_REL * w.abs().amax(-1) + 1e-6
    assert bool((err <= allow).all()), float((err / allow).max())


@pytest.mark.parametrize("shape", [
    # (B, S, H, KV, hd, window, softcap, query scale); a query scale of 8
    # makes the softmax peaked
    (2, 64, 4, 2, 32, None, None, 1),
    (2, 96, 8, 1, 16, None, None, 1),
    (1, 37, 4, 2, 128, 16, 50.0, 1),
    (1, 300, 8, 4, 256, None, 50.0, 1),   # gemma2-2b's head shape
    (1, 300, 8, 4, 256, 128, 50.0, 1),
    (1, 300, 8, 4, 256, 16, 50.0, 1),
    (1, 1000, 8, 4, 256, 128, 50.0, 8),
    # edges of the 128-row query tiles and the 64-key KV tiles, B = 2
    *[(2, s, 4, 2, 64, None, 50.0, 1)
      for s in (1, 63, 64, 65, 127, 128, 129, 300)],
    # every head dim of HEAD_DIMS on the one design
    *[(1, 129, 4, 2, hd, None, None, 1) for hd in (16, 32, 64, 128, 256)],
    # groups of 1, 2 and 16 query heads over a KV head
    *[(1, 200, 16, 16 // g, 128, 100, None, 1) for g in (1, 2, 16)],
    # a window shorter than a tile and one longer than S
    (2, 300, 8, 4, 256, 16, 50.0, 8),
    (2, 300, 8, 4, 256, 1000, 50.0, 1),
])
def test_flash_attention_kernel_matches_plain(cuda_device, shape):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    b, s, h, kv, hd, window, cap, qs = shape
    rng = np.random.default_rng(s)
    q, k, v = (_bf16(rng, (b, s, n, hd), cuda_device) for n in (h, kv, kv))
    q = q * qs
    before = fa_kernel.flash_attention_cuda.launches
    got = fa_ops.flash_attention(q, k, v, window=window, softcap=cap,
                                 kernel="on")
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention_cuda.launches == before + 1
    want = fa_ops.flash_attention(q, k, v, window=window, softcap=cap,
                                  kernel="off")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _assert_attention_close(got, want, absolute=qs == 1)


@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention_kernel_matches_plain(cuda_device, ring):
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ops as da_ops
    b, length, h, kv, hd = 1, 512, 8, 4, 256
    pos = 700 if ring else 400
    rng = np.random.default_rng(pos)
    q = _bf16(rng, (b, 1, h, hd), cuda_device)
    k, v = (_bf16(rng, (b, length, kv, hd), cuda_device) for _ in range(2))
    s = np.arange(length)
    slots = (pos - (pos - s) % length) if ring else np.where(s <= pos, s, -1)
    slots = torch.from_numpy(slots.astype(np.int32)).to(cuda_device)
    kw = dict(window=length if ring else None, softcap=50.0)
    before = da_kernel.decode_attention_cuda.launches
    got = da_ops.decode_attention(q, k, v, slots, pos, kernel="on", **kw)
    torch.cuda.synchronize()
    assert da_kernel.decode_attention_cuda.launches == before + 1
    want = da_ops.decode_attention(q, k, v, slots, pos, kernel="off", **kw)
    _assert_attention_close(got, want)


@pytest.mark.parametrize("case", [
    # (cache length, pos, window, slot layout)
    (512, 300, 64, "filled"),    # positions past pos, and a window
    (64, 40, 64, "ring"),        # a ring before it wraps
    (64, 1000, 64, "ring"),      # and after
    (128, 23, None, "dense"),    # the served path's dense cache
])
def test_decode_attention_kernel_masks_like_plain(cuda_device, case):
    from repro_torch.kernels.decode_attention import ops as da_ops
    length, pos, window, layout = case
    rng = np.random.default_rng(length + pos)
    q = _bf16(rng, (1, 1, 8, 256), cuda_device)
    k, v = (_bf16(rng, (1, length, 4, 256), cuda_device) for _ in range(2))
    s = np.arange(length)
    slots = {"filled": s, "ring": pos - (pos - s) % length,
             "dense": np.where(s <= pos, s, -1)}[layout]
    slots = torch.from_numpy(slots.astype(np.int32)).to(cuda_device)
    got, want = (da_ops.decode_attention(q, k, v, slots, pos, window=window,
                                         softcap=50.0, kernel=mode)
                 for mode in ("on", "off"))
    _assert_attention_close(got, want)


@pytest.mark.parametrize("case", [
    # (B, cache length, H, KV, pos, window, slot layout)
    (1, 1, 8, 4, 0, None, "dense"),          # one slot
    (1, 4672, 8, 4, 4623, None, "dense"),    # not a multiple of the split
    (1, 8192, 8, 4, 8000, None, "dense"),    # many splits and clusters
    (1, 4672, 8, 4, 4623, None, "gap"),      # empty splits between live ones
    (2, 512, 8, 4, 400, None, "dense"),      # B = 2 with KV = 4
    (2, 300, 8, 4, 700, 300, "ring"),
    (1, 2048, 16, 1, 2575, 2048, "ring"),    # recurrentgemma-9b's MQA ring
])
def test_decode_attention_kernel_splits(cuda_device, case):
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ops as da_ops
    b, length, h, kv, pos, window, layout = case
    rng = np.random.default_rng(length + pos)
    q = _bf16(rng, (b, 1, h, 256), cuda_device)
    k, v = (_bf16(rng, (b, length, kv, 256), cuda_device) for _ in range(2))
    s = np.arange(length)
    slots = {"dense": np.where(s <= pos, s, -1),
             "gap": np.where((s <= pos) & ((s < 1000) | (s >= 1300)), s, -1),
             "ring": pos - (pos - s) % length}[layout]
    slots = torch.from_numpy(slots.astype(np.int32)).to(cuda_device)
    kw = dict(window=window, softcap=None if h == 16 else 50.0)
    for _ in range(2):  # the second call finds the counters as the first left
        before = da_kernel.decode_attention_cuda.launches
        got = da_ops.decode_attention(q, k, v, slots, pos, kernel="on", **kw)
        torch.cuda.synchronize()
        assert da_kernel.decode_attention_cuda.launches == before + 1
        want = da_ops.decode_attention(q, k, v, slots, pos, kernel="off",
                                       **kw)
        _assert_attention_close(got, want)


@pytest.mark.parametrize("op", ["flash_attention", "decode_attention"])
def test_attention_kernels_launch_once_per_call(cuda_device, op):
    """The profiler sees one device kernel per call, and it is the
    kernel's own."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    rng = np.random.default_rng(5)
    if op == "flash_attention":
        q, k, v = (_bf16(rng, (1, 300, n, 256), cuda_device) for n in (8, 4, 4))

        def call():
            return fa_ops.flash_attention(q, k, v, softcap=50.0, kernel="on")
    else:
        q = _bf16(rng, (1, 1, 8, 256), cuda_device)
        k, v = (_bf16(rng, (1, 4672, 4, 256), cuda_device) for _ in range(2))
        slots = torch.arange(4672, dtype=torch.int32, device=cuda_device)

        def call():
            return da_ops.decode_attention(q, k, v, slots, 4623, softcap=50.0,
                                           kernel="on")
    call()  # builds, loads and allocates what stays
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and f"{op}_kernel" in kernels[0], kernels


def test_smoke_model_kernels_match_plain(cuda_device):
    """gemma2-2b's smoke model on the card: prefill past the window, then
    decode steps, with the kernels and with their plain versions. Logits
    to 0.21, the tolerance of tests/test_torch_lm.py."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode, lm
    cfg = get_smoke_config("gemma2-2b")
    model = lm.init(torch.Generator(cuda_device).manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 40))).to(cuda_device)
    out = {}
    for mode in ("on", "off"):
        logits, cache = decode.prefill(model, toks, 64, kernel=mode)
        steps = [logits]
        for i in range(4):
            logits, cache = decode.decode_step(model, cache, toks[:, i:i + 1],
                                               40 + i, kernel=mode)
            steps.append(logits)
        out[mode] = torch.stack(steps)
    assert float((out["on"] - out["off"]).abs().max()) <= 0.21


# ---------------------------------------------------------------------------
# recurrent kernels. ssd_scan sums float32 products in another order than
# its plain version: the gate of tests/test_kernels.py, elementwise
# |err| <= 5e-3 + 5e-3 |plain|. rglru_scan rounds each multiply and add as
# its plain version does: bit for bit.
# ---------------------------------------------------------------------------

SSD_TOL = 5e-3


def _ssd_args(rng, b, nc, q, h, p, n, device, valid=None):
    f32 = np.float32
    xc = rng.standard_normal((b, nc, q, h, p)).astype(f32)
    bc = rng.standard_normal((b, nc, q, n)).astype(f32)
    cc = rng.standard_normal((b, nc, q, n)).astype(f32)
    dtc = np.log1p(np.exp(rng.standard_normal((b, nc, q, h)))).astype(f32)
    if valid is not None:  # a padded chunk: dt = 0 (and x, B, C = 0) past it
        for x in (xc, bc, cc, dtc):
            x[:, :, valid:] = 0
    a = -np.exp(rng.standard_normal(h) * 0.2).astype(f32)
    cum = np.cumsum(dtc * a, axis=2).astype(f32)
    return [torch.from_numpy(x).to(device) for x in (xc, bc, cc, dtc, cum)]


@pytest.mark.parametrize("shape", [
    # (B, NC, Q, H, P, N, valid rows of the last chunk)
    (2, 4, 16, 4, 32, 16, None),     # tests/test_kernels.py's shapes
    (1, 4, 32, 2, 64, 32, None),
    (2, 12, 8, 4, 16, 8, None),
    (1, 1, 100, 3, 24, 40, None),    # tile edges in Q, P and N
    (1, 2, 256, 32, 64, 128, None),  # mamba2-370m
    (1, 1, 256, 32, 64, 128, 16),    # a 16-token prompt, padded
])
def test_ssd_scan_kernel_matches_plain(cuda_device, shape):
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    *dims, valid = shape
    args = _ssd_args(np.random.default_rng(sum(dims)), *dims, cuda_device,
                     valid)
    before = ssd_kernel.ssd_intra_chunk_cuda.launches
    got = ssd_ops.ssd_intra_chunk(*args, kernel="on")
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_intra_chunk_cuda.launches == before + 1
    want = ssd_ops.ssd_intra_chunk(*args, kernel="off")
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= SSD_TOL + SSD_TOL * w.abs()).all()), \
            float(((g - w).abs() / (SSD_TOL + SSD_TOL * w.abs())).max())


@pytest.mark.parametrize("shape", [(1, 300, 4096), (2, 77, 96), (3, 5, 40)])
def test_rglru_scan_kernel_bit_equal_plain(cuda_device, shape):
    from repro_torch.kernels.rglru_scan import kernel as scan_kernel
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    rng = np.random.default_rng(shape[1])
    a = torch.from_numpy((1 / (1 + np.exp(-rng.standard_normal(shape))))
                         .astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda_device)
    before = scan_kernel.linear_scan_cuda.launches
    got = scan_ops.linear_scan(a, b, kernel="on")
    torch.cuda.synchronize()
    assert scan_kernel.linear_scan_cuda.launches == before + 1
    assert torch.equal(got, scan_ops.linear_scan(a, b, kernel="off"))


@pytest.mark.parametrize("window", [None, 64])
def test_attention_kernels_at_mqa_group_16(cuda_device, window):
    """recurrentgemma-9b's local layers: 16 query heads over one KV head,
    head_dim 256, no softcap."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    rng = np.random.default_rng(16)
    q, k, v = (_bf16(rng, (1, 200, n, 256), cuda_device)
               for n in (16, 1, 1))
    got, want = (fa_ops.flash_attention(q, k, v, window=window, kernel=mode)
                 for mode in ("on", "off"))
    _assert_attention_close(got, want)
    length, pos = 64, 150
    s = np.arange(length)
    slots = torch.from_numpy((pos - (pos - s) % length).astype(np.int32)).to(
        cuda_device)
    qd = _bf16(rng, (1, 1, 16, 256), cuda_device)
    kd, vd = (_bf16(rng, (1, length, 1, 256), cuda_device) for _ in range(2))
    got, want = (da_ops.decode_attention(qd, kd, vd, slots, pos,
                                         window=window, kernel=mode)
                 for mode in ("on", "off"))
    _assert_attention_close(got, want)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_smoke_models_kernels_match_plain(cuda_device, arch):
    """The recurrent smoke models on the card: prefill of 21 tokens
    (recurrentgemma's window of 16 wraps), then 4 decode steps, with the
    kernels and with their plain versions. Logits within twice the plain
    path's own float32-vs-bf16 distance (tests/test_torch_recurrent_lm.py)."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode, lm
    cfg = get_smoke_config(arch)
    model = lm.init(torch.Generator(cuda_device).manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 25))).to(cuda_device)
    out = {}
    for name, m, mode in (("on", model, "on"), ("off", model, "off"),
                          ("off32", copy.deepcopy(model).float(), "off")):
        logits, cache = decode.prefill(m, toks[:, :21], 64, kernel=mode)
        steps = [logits]
        for i in range(4):
            logits, cache = decode.decode_step(m, cache, toks[:, 21 + i:22 + i],
                                               21 + i, kernel=mode)
            steps.append(logits)
        out[name] = torch.stack(steps)
    floor = float((out["off32"] - out["off"]).abs().max())
    assert float((out["on"] - out["off"]).abs().max()) <= 2 * floor

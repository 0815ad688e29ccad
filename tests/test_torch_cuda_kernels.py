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


@pytest.mark.parametrize("n_seeds", [1, 2])
def test_chunk_arrival_offsets_are_the_same_bits_every_run(cuda_device,
                                                          n_seeds):
    # a figure's one-seed stream at full length: the engine's inputs, and
    # so its summaries, must not vary from run to run on the card
    from repro_torch.core import queueing
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    gaps = torch.rand((n_seeds, 80_384), generator=gen, device=cuda_device)
    services = torch.rand((n_seeds, 80_384, 2), generator=gen,
                          device=cuda_device)
    runs = [queueing._chunk_inputs(gaps, services, 0, 80_000, 8_000)[0]
            for _ in range(20)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    want = torch.cumsum(gaps.cpu().double() * (torch.arange(80_384) < 80_000),
                        dim=1)
    assert torch.allclose(runs[0].cpu().double(), want, rtol=1e-5)


def test_chunk_arrival_offsets_do_not_depend_on_the_blocks_height(
        cuda_device):
    # a shard's block holds some of the grid's rows: each row must scan to
    # the same bits as in the whole block (sharded == unsharded)
    from repro_torch.core import queueing
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    gaps = torch.rand((40, 4096), generator=gen, device=cuda_device)
    whole = queueing._row_cumsum(gaps)
    for rows in ([7], [0, 1], list(range(3, 11)), list(range(15)),
                 list(range(17)), list(range(2, 32))):
        assert torch.equal(queueing._row_cumsum(gaps[rows]), whole[rows])


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


def test_sharded_kernel_run_equals_unsharded(cuda_device):
    # three shards on one card: 2 seeds x 2 loads x 4 variants = 16 cells
    # padded to 18, every shard's cells through cell_update once a chunk
    from repro_torch.launch.mesh import make_sweep_mesh
    d = dists.pareto(2.2)
    grid = (Scenario.paper_default(d, ks=(1, 2)),
            Scenario(dists=d, policy=CANCEL_ON_COMPLETE, ks=(3,),
                     service_model=SERVER_DEPENDENT, mix=0.4),
            Scenario(dists=d, policy=HEDGE_AFTER_DELAY, delay=0.5, ks=(2,),
                     degradation=Degradation(p_fail=0.05)))
    kw = dict(n_seeds=2, percentiles=(50.0, 99.0), chunk_size=1500,
              kernel="auto", device="cuda")
    cfg = queueing.SimConfig(n_servers=20, n_arrivals=4_000)
    mesh = make_sweep_mesh(devices=(cuda_device,) * 3)
    a = queueing.run(3, grid, [0.1, 0.3], cfg, **kw)
    cell_kernel.cell_update_cuda.launches = 0
    b = queueing.run(3, grid, [0.1, 0.3], cfg, mesh=mesh, **kw)
    assert cell_kernel.cell_update_cuda.launches == 3 * 3  # shards x chunks
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


@pytest.mark.parametrize("h, kv, hd", [
    # the heads of nemotron-4-15b, llava-next-34b, command-r-35b (groups of
    # 6, 7 and 8 at hd 128), musicgen-large (MHA: one query head a KV head)
    # and granite-moe-3b-a800m (3 at hd 64)
    (48, 8, 128), (56, 8, 128), (64, 8, 128), (32, 32, 64), (24, 8, 64)])
@pytest.mark.parametrize("qs", [1, 8])
def test_attention_kernels_at_the_model_zoo_groups(cuda_device, h, kv, hd,
                                                   qs):
    """Both kernels, dense and causal, at the head shapes of the models
    that serve them beyond gemma2-2b and recurrentgemma-9b: a partial last
    query tile (S = 300) and a dense cache of 700 slots at pos 650."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    rng = np.random.default_rng(h + kv + hd)
    q, k, v = (_bf16(rng, (1, 300, n, hd), cuda_device) for n in (h, kv, kv))
    got, want = (fa_ops.flash_attention(qs * q, k, v, kernel=mode)
                 for mode in ("on", "off"))
    _assert_attention_close(got, want, absolute=qs == 1)
    q = qs * _bf16(rng, (1, 1, h, hd), cuda_device)
    k, v = (_bf16(rng, (1, 700, kv, hd), cuda_device) for _ in range(2))
    s = torch.arange(700, dtype=torch.int32, device=cuda_device)
    slots = torch.where(s <= 650, s, -1)
    got, want = (da_ops.decode_attention(q, k, v, slots, 650, kernel=mode)
                 for mode in ("on", "off"))
    _assert_attention_close(got, want, absolute=qs == 1)


def test_head_dim_outside_the_kernels_raises_not_falls_back(cuda_device):
    """command-r-35b's smoke config has head_dim 8, which no kernel takes:
    under ``kernel="auto"`` its prefill raises on the card (no quiet route
    to the plain version), and it runs with ``kernel="off"`` asked for."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode, lm
    cfg = get_smoke_config("command-r-35b")
    assert cfg.head_dim == 8
    model = lm.init(torch.Generator(cuda_device).manual_seed(0), cfg)
    toks = torch.zeros((1, 12), dtype=torch.long, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        decode.prefill(model, toks, 32)
    logits, cache = decode.prefill(model, toks, 32, kernel="off")
    logits, _ = decode.decode_step(model, cache, toks[:, :1], 12,
                                   kernel="off")
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("op", ["flash_attention", "decode_attention",
                                "ssd_scan", "rglru_scan"])
def test_kernels_launch_once_per_call(cuda_device, op):
    """The profiler sees one device kernel per call, and it is the
    kernel's own (the recurrent kernels at their served shapes too)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    rng = np.random.default_rng(5)
    if op == "flash_attention":
        q, k, v = (_bf16(rng, (1, 300, n, 256), cuda_device) for n in (8, 4, 4))

        def call():
            return fa_ops.flash_attention(q, k, v, softcap=50.0, kernel="on")
    elif op == "ssd_scan":
        args = _ssd_args(rng, 1, 1, 256, 32, 64, 128, cuda_device, valid=16)

        def call():
            return ssd_ops.ssd_intra_chunk(*args, kernel="on")
    elif op == "rglru_scan":
        a, b = (torch.from_numpy(rng.random((1, 16, 4096), dtype=np.float32))
                .to(cuda_device) for _ in range(2))

        def call():
            return scan_ops.linear_scan(a, b, kernel="on")
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


@pytest.mark.parametrize("run", ["adaptive", "crash"])
def test_smoke_model_behind_the_batched_service(cuda_device, run):
    """gemma2-2b's smoke model on the card behind ``BatchedHedgedService``
    (4 replicas, one model; an ``AdaptiveController``, or static k=2 with
    a replica crashed a third of the way in): every request completes
    and its tokens equal a lone engine's (kernels on) for its prompt."""
    from repro_torch.examples import serve_hedged
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.serving.controller import PolicyTable
    from repro_torch.serving.engine import InferenceEngine
    cfg, model, engines = serve_hedged.make_replicas("gemma2-2b", True, 4,
                                                     cuda_device)
    lone = InferenceEngine(cfg, model, max_len=64, name="lone",
                           device=cuda_device)
    mean_s = serve_hedged.mean_service_s(lone)
    table = PolicyTable(rhos=[0.05, 0.3, 0.8], k=[1, 2, 2],
                        delay=[0.0, 0.0, 0.5],
                        tail=[[5.0, 2.0, 3.0], [6.0, 4.0, 3.5],
                              [9.0, 30.0, 20.0]])
    kw = ({"table": table} if run == "adaptive"
          else {"k": 2, "crash": "r0", "seed": 1,
                "shed_watermark": serve_hedged.STATIC_NO_SHED})
    fa0 = fa_kernel.flash_attention_cuda.launches
    da0 = da_kernel.decode_attention_cuda.launches
    out = serve_hedged.live_replay(engines, n_requests=12, mean_s=mean_s,
                                   vocab=cfg.vocab_size, **kw)
    assert fa_kernel.flash_attention_cuda.launches > fa0
    assert da_kernel.decode_attention_cuda.launches > da0
    assert out["telemetry"]["completions"] == 12
    assert out["stats"]["failed"] == 0
    assert serve_hedged.check_tokens(lone, out["requests"]) == []


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
    # edges of the tiles, the slices, the state blocks and the head groups
    (1, 1, 1, 4, 16, 8, None),       # Q of 1
    (1, 3, 63, 3, 24, 40, None),     # Q of a tile - 1
    (1, 2, 65, 5, 64, 128, 20),      # Q of a tile + 1, padded
    (2, 1, 100, 6, 128, 256, None),  # P and N of two state blocks
    (1, 1, 256, 32, 128, 256, None),
    (1, 16, 256, 32, 64, 128, None),  # 16 chunks: four heads a y CTA
    (2, 8, 256, 4, 64, 128, 16),     # BC of 16, padded chunks
    (1, 2, 50, 3, 10, 13, None),     # P and N not multiples of 4
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


@pytest.mark.parametrize("shape", [
    (1, 300, 4096), (2, 77, 96), (3, 5, 40),
    # L of 1, of a tile -/+ 1 (the direct kernel up to 64 steps), ragged;
    # B of 1-3; W of a strip's part
    (1, 1, 4096), (2, 63, 96), (1, 64, 4096), (3, 65, 40), (1, 2573, 4096),
    (1, 16, 4096), (2, 129, 4096), (3, 256, 12), (1, 1000, 96)])
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


def test_rglru_scan_kernel_bit_equal_plain_near_float32_max(cuda_device):
    # h settles at b / (1 - a) ~ 1e38, near float32's largest value
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    rng = np.random.default_rng(38)
    shape = (2, 700, 96)
    a = torch.from_numpy(rng.uniform(0.985, 0.995, shape).astype(
        np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.uniform(0.5e36, 1.5e36, shape).astype(
        np.float32)).to(cuda_device)
    want = scan_ops.linear_scan(a, b, kernel="off")
    assert float(want.abs().max()) > 1e38
    assert torch.equal(scan_ops.linear_scan(a, b, kernel="on"), want)


def test_rglru_scan_kernel_takes_unaligned_views_and_rejects_odd_widths(
        cuda_device):
    # a view that starts 4 bytes into its storage is copied, not refused;
    # rows that are not 16-byte multiples cannot go through the TMA
    from repro_torch.kernels.rglru_scan import kernel as scan_kernel
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    rng = np.random.default_rng(4)
    base = torch.from_numpy(rng.random(1 + 2 * 70 * 96, dtype=np.float32)).to(
        cuda_device)
    a = base[1:].view(2, 70, 96)
    b = torch.from_numpy(rng.standard_normal((2, 70, 96)).astype(
        np.float32)).to(cuda_device)
    assert a.data_ptr() % 16 != 0
    assert torch.equal(scan_ops.linear_scan(a, b, kernel="on"),
                       scan_ops.linear_scan(a, b, kernel="off"))
    with pytest.raises(ValueError):
        scan_kernel.linear_scan_cuda(a[..., :13].contiguous(),
                                     b[..., :13].contiguous())


def test_recurrent_plans_smem_equal_the_library_layouts(cuda_device):
    # every plan the wrappers can choose: ssd_scan's count depends on Q
    # and P alone, rglru_scan's on the stages (0: the direct kernel)
    from repro_torch.kernels.rglru_scan import kernel as scan_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    for q in (1, 63, 64, 65, 100, 128, 200, 256, 257, 512, 640):
        for p in range(1, ssd_kernel.MAX_P + 1):
            need = ssd_kernel.smem_bytes(q, p)
            if need <= ssd_kernel.MAX_SMEM_BYTES:
                assert ssd_kernel.library_smem_bytes(q, p) == need, (q, p)
    for stages in range(scan_kernel.MAX_STAGES + 1):
        assert scan_kernel.library_smem_bytes(stages) == \
            scan_kernel.smem_bytes(stages), stages


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


def _smoke_trainable(device, arch="gemma2-2b"):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = get_smoke_config(arch)
    return lm.init(torch.Generator(device).manual_seed(0),
                   cfg).requires_grad_(True)


def _markov_batch(cfg, device, seq=32, batch=2):
    from repro_torch.data.pipeline import DataConfig, MarkovSource
    nb = MarkovSource(cfg, DataConfig(seq_len=seq, batch_size=batch)
                      ).batch_at(0)
    return {k: torch.from_numpy(v).to(device) for k, v in nb.items()}


def _loss_grads(model, batch):
    from repro_torch.models import lm
    for p in model.parameters():
        p.grad = None
    total, _ = lm.loss_fn(model, batch)
    total.backward()
    return float(total.detach()), {
        n: p.grad.float().cpu() for n, p in model.named_parameters()}


def _worst_rel(got, want):
    return max(float((got[k] - w).abs().max()) / float(w.abs().max())
               for k, w in want.items() if float(w.abs().max()) > 0)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-370m"])
def test_train_step_on_the_card(cuda_device, arch):
    """One training step of a smoke model on the card: the loss within
    1e-3 relative of the same weights' loss on the CPU (the loss
    tolerance of tests/test_torch_train_lm.py), the grads within twice
    the card's own bf16 floor (its float32 copy's distance) of the CPU's,
    no kernel launched, and ``make_train_step`` updates every parameter
    with a finite grad norm (every float32 master moves)."""
    import copy

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models import lm
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.step import make_train_step
    model = _smoke_trainable(cuda_device, arch)
    batch = _markov_batch(model.cfg, cuda_device)
    cpu = copy.deepcopy(model).cpu()
    before = (fa_kernel.flash_attention_cuda.launches,
              ssd_kernel.ssd_intra_chunk_cuda.launches)
    loss, grads = _loss_grads(model, batch)
    loss32, grads32 = _loss_grads(copy.deepcopy(model).float(), batch)
    want_loss, want = _loss_grads(cpu, {k: v.cpu() for k, v in
                                        batch.items()})
    assert abs(loss - want_loss) <= 1e-3 * abs(want_loss)
    assert _worst_rel(grads, want) <= 2 * _worst_rel(grads32, grads)
    opt = make_optimizer("adamw", lr=1e-3)
    state = opt.init(dict(model.named_parameters()), lm.leaf_groups(model))
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, state, metrics = make_train_step(model.cfg, opt)(model, state, batch,
                                                        0)
    assert torch.isfinite(metrics["grad_norm"]) and \
        torch.isfinite(metrics["loss"])
    assert all(not torch.equal(state["master"][n], old[n].float())
               for n in old)
    assert (fa_kernel.flash_attention_cuda.launches,
            ssd_kernel.ssd_intra_chunk_cuda.launches) == before


def test_kernels_refuse_grad_requiring_inputs(cuda_device):
    """The CUDA kernels have no backward: a launch on an input that
    requires grad raises and launches nothing, as does ``loss_fn`` with
    ``kernel="auto"`` on a trainable model; under ``no_grad`` both
    launch."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import lm
    g = torch.Generator(cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, 64, h, 256), generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for h in (8, 4, 4))
    q.requires_grad_(True)
    n = fa_kernel.flash_attention_cuda.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention(q, k, v, kernel="on")
    assert fa_kernel.flash_attention_cuda.launches == n
    with torch.no_grad():
        fa_ops.flash_attention(q, k, v, kernel="on")
    assert fa_kernel.flash_attention_cuda.launches == n + 1
    model = _smoke_trainable(cuda_device)
    batch = _markov_batch(model.cfg, cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        lm.loss_fn(model, batch, kernel="auto")
    assert fa_kernel.flash_attention_cuda.launches == n + 1
    with torch.no_grad():
        lm.loss_fn(model, batch, kernel="auto")
    assert fa_kernel.flash_attention_cuda.launches == n + 1 + sum(
        kind in ("global", "local") for kind in model.cfg.layer_kinds)


def test_crash_resume_bitwise_on_the_card(cuda_device, tmp_path,
                                          monkeypatch):
    """The trainer's restart contract on the card, at the JAX test's tiny
    config, under deterministic algorithms: a run that fails at step 5
    and resumes from its step-3 checkpoint ends with the parameters and
    optimizer state of an uninterrupted run, bit for bit."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.training.train_loop import (Trainer, TrainerConfig,
                                                 deterministic)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                      vocab_size=64, pattern=("global",),
                      tie_embeddings=True, recipe="tp",
                      long_context_ok=False)

    def make(d, fail_at=None):
        return Trainer(cfg, DataConfig(seq_len=16, batch_size=4, seed=1),
                       TrainerConfig(ckpt_dir=str(tmp_path / d),
                                     ckpt_every=3, log_every=100,
                                     fail_at_step=fail_at),
                       log_fn=lambda *_: None, device=cuda_device)

    with deterministic():
        straight = make("a").run(8)
        with pytest.raises(RuntimeError, match="injected failure"):
            make("b", 5).run(8)
        resumed = make("b").run(8)
    a = dict(straight["model"].named_parameters())
    b = dict(resumed["model"].named_parameters())
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for part in ("m", "v", "master"):
        for k in a:
            assert torch.equal(straight["opt"][part][k],
                               resumed["opt"][part][k]), (part, k)

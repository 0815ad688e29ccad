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

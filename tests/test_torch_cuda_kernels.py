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

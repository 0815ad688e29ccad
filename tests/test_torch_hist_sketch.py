"""The PyTorch port's histogram sketch against the JAX package's.

Inputs are drawn with numpy and handed to both packages. ``hist_accum``
counts must be bit-equal; ``bin_indices`` must be bit-equal except where
``torch.log`` and ``jnp.log`` round one ULP apart across a bin boundary
— such flips are counted, must move an index by exactly one bin, and
are bounded. The CUDA kernel against the plain version is
``tests/test_torch_cuda_kernels.py``, on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hist_sketch import ops as jops
from repro_torch.kernels.hist_sketch import ops


def _rand_idx(seed, t, c, n_bins):
    idx = np.random.default_rng(seed).integers(-1, n_bins, (t, c))
    idx[0, 0], idx[-1, -1] = 0, n_bins - 1   # both edge bins
    return idx.astype(np.int32)


def _responses(seed, shape):
    """Positive values spanning the sketch range and beyond it."""
    rng = np.random.default_rng(seed)
    v = rng.exponential(size=shape) * 10.0 ** rng.uniform(-4, 5.5, shape)
    return v.astype(np.float32)


class TestHistAccum:
    @pytest.mark.parametrize("t,c,n_bins", [
        (1024, 5, 2048), (512, 1, 128), (768, 16, 256), (777, 3, 100)])
    def test_bit_equal_to_reference(self, t, c, n_bins):
        idx = _rand_idx(t + c, t, c, n_bins)
        out = ops.hist_accum(torch.from_numpy(idx), n_bins=n_bins)
        expect = np.asarray(jops.hist_accum(jnp.asarray(idx), n_bins=n_bins,
                                            interpret=True))
        assert out.dtype == torch.float32 and out.shape == (c, n_bins)
        np.testing.assert_array_equal(out.numpy(), expect)

    def test_skip_entries_add_nothing(self):
        idx = torch.full((512, 4), -1, dtype=torch.int32)
        assert float(ops.hist_accum(idx, n_bins=128).sum()) == 0.0

    def test_total_mass_equals_valid_entries(self):
        idx = torch.from_numpy(_rand_idx(3, 640, 6, 512))
        out = ops.hist_accum(idx, n_bins=512)
        assert float(out.sum()) == float((idx >= 0).sum())

    def test_kernel_on_cpu_tensor_raises(self):
        idx = torch.from_numpy(_rand_idx(1, 64, 2, 128))
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.hist_accum(idx, n_bins=128, kernel="on")
        with pytest.raises(ValueError, match="kernel"):
            ops.hist_accum(idx, n_bins=128, kernel="interpret")


class TestBinning:
    @pytest.mark.parametrize("n_bins", [100, 256, 2048])
    def test_log_scale_matches_reference(self, n_bins):
        jlo, jscale = jops._log_scale(n_bins, jops.HIST_LO, jops.HIST_HI)
        assert ops.log_scale(n_bins) == (float(jlo), float(jscale))

    @pytest.mark.parametrize("n_bins", [100, 2048])
    def test_bin_indices_match_reference_flips_counted(self, n_bins):
        v = _responses(n_bins, (4096, 64))
        warm = (np.random.default_rng(0).random((4096, 64)) > 0.1).astype(
            np.float32)
        got = ops.bin_indices(torch.from_numpy(v), torch.from_numpy(warm),
                              n_bins=n_bins).numpy()
        want = np.asarray(jops.bin_indices(jnp.asarray(v), jnp.asarray(warm),
                                           n_bins=n_bins))
        assert got.dtype == np.int32
        diff = got != want
        # a flip needs the two logs to differ, so it moves one bin at most
        assert np.all(np.abs(got[diff] - want[diff]) == 1)
        # a 1-ULP log gap straddles a bin edge ~1e-5 of the time; 262k
        # values allow a handful
        assert diff.sum() <= 10, int(diff.sum())
        np.testing.assert_array_equal(got[warm == 0], -1)

    def test_edges_clamp_and_inf_masks(self):
        v = torch.tensor([[1e-9], [1e9], [math.inf], [1.0]])
        w = torch.tensor([[1.0], [1.0], [0.0], [1.0]])
        idx = ops.bin_indices(v, w, n_bins=2048)[:, 0].tolist()
        assert idx[:3] == [0, 2047, -1] and 0 < idx[3] < 2047


class TestQuantiles:
    def test_sketch_quantiles_match_reference(self):
        hist = np.random.default_rng(4).integers(
            0, 50, (3, 2, 2048)).astype(np.float32)
        qs = (50.0, 90.0, 99.0, 99.9)
        got = ops.sketch_quantiles(torch.from_numpy(hist), qs).numpy()
        want = np.asarray(jops.sketch_quantiles(jnp.asarray(hist),
                                                jnp.asarray(qs)))
        # same bin; the midpoint's exp may round one ULP apart
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)

    @pytest.mark.parametrize("family", ["exponential", "lognormal"])
    def test_quantile_error_within_one_log_bin(self, family):
        rng = np.random.default_rng(9)
        x = (rng.exponential(size=(20_000, 2)) if family == "exponential"
             else rng.lognormal(0.0, 1.5, (20_000, 2))).astype(np.float32)
        hist = ops.hist_sketch(torch.from_numpy(x), n_bins=2048)
        est = ops.sketch_quantiles(hist, (50.0, 99.0)).numpy()
        exact = np.percentile(x, (50.0, 99.0), axis=0)
        _, scale = ops.log_scale(2048)
        np.testing.assert_allclose(est, exact, rtol=math.expm1(1.0 / scale))

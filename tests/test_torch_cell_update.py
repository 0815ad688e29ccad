"""The PyTorch port's plain cell update against the JAX package's, bit for bit.

One chunk of injected inputs (``repro_torch.interop.synthetic_chunk``,
drawn with numpy) goes through ``repro.kernels.cell_update.ref.
cell_update_ref`` (the reference's ``kernel="off"`` path, as its own CPU
tests run it) and through the port's ``cell_update_ref``; ``free``,
``ssum``, ``comp``, ``cnt`` and the histogram must be bit-equal, for
every policy, service model, degradation, timed and ``has_dists`` arm.

Knob values (``interop.CELL_UPDATE_ARMS``): XLA's CPU backend contracts ``mix * shared + (1 - mix) *
svc`` into a fused multiply-add, which rounds once where the port (and
its CUDA kernel, built with ``--fmad=false``) rounds each product. The
arms therefore use ``mix = 0.5`` and delays whose products with the
backoff coefficients are exact, so the comparison does not depend on
contraction; ``test_generic_mix_differs_only_by_contraction`` measures
the gap at a generic mix. The CUDA kernel against this plain version is
``tests/test_torch_cuda_kernels.py``, on the card.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cell_update import ref as jref
from repro_torch import interop
from repro_torch.kernels.cell_update import kernel as cell_kernel
from repro_torch.kernels.cell_update import ops, ref

FIELDS = ("free", "ssum", "comp", "cnt", "hist")

ARMS = interop.CELL_UPDATE_ARMS


def _port_args(args, device="cpu"):
    """The injected numpy chunk as the port's tensors, through interop."""
    t = {k: interop.to_tensor(v, device) for k, v in args.items()}
    t.update(zip(FIELDS, interop.carry_from_numpy(
        *(args[k] for k in FIELDS), device=device)))
    t["cum"], t["servers"], t["services"] = interop.chunk_from_numpy(
        args["cum"], args["servers"], args["services"], device)
    return [t[k] for k in interop.CELL_UPDATE_ARGS]


def _both(args, static, block=512):
    jax_out = jref.cell_update_ref(
        *(jnp.asarray(args[k]) for k in interop.CELL_UPDATE_ARGS),
        block=block, **static)
    port_out = ref.cell_update_ref(*_port_args(args), block=block, **static)
    return ([np.asarray(x) for x in jax_out],
            [x.numpy() for x in port_out])


class TestBitParityWithReference:
    @pytest.mark.parametrize("arm", list(ARMS))
    def test_chunk_bit_equal(self, arm):
        args, static = interop.synthetic_chunk(
            len(arm), n_cells=15, n_servers=6, steps=1024, **ARMS[arm])
        want, got = _both(args, static)
        for name, w, g in zip(FIELDS, want, got):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        if args["hist"].size:   # the sketch did count this chunk
            assert got[4].sum() > args["hist"].sum()

    def test_generic_mix_differs_only_by_contraction(self):
        # mix = 0.6: XLA fuses the blend on the CPU, the port does not.
        # Responses then differ by an ULP now and then; the sums stay
        # within float32 noise and the counts are unaffected.
        args, static = interop.synthetic_chunk(
            5, n_cells=12, n_servers=6, steps=1024, models=(1,), mix=0.6)
        want, got = _both(args, static)
        np.testing.assert_array_equal(got[3], want[3])          # cnt
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
        assert np.abs(got[4] - want[4]).sum() <= 4               # bin flips

    def test_cost_model_matches_reference(self):
        from repro.kernels.cell_update import ops as jops
        kw = dict(n_cells=1440, n_servers=20, k_max=2, n_arrivals=50_000,
                  n_bins=2048, n_seeds=30, chunk=4096)
        for need_hist in (True, False):
            assert ops.cell_update_costs(need_hist=need_hist, **kw) == \
                jops.cell_update_costs(need_hist=need_hist, **kw)

    def test_retry_offsets_match_reference(self):
        for k in range(1, 9):
            assert ref.retry_offsets(k) == jref.retry_offsets(k)

    def test_kahan_fold_bit_equal(self):
        rng = np.random.default_rng(2)
        ssum, comp, resp = (rng.normal(size=4096).astype(np.float32) * s
                            for s in (1e3, 1e-4, 10.0))
        w = (rng.random(4096) > 0.3).astype(np.float32)
        want = jref.kahan_fold(*(jnp.asarray(x) for x in (ssum, comp, resp,
                                                          w)))
        got = ref.kahan_fold(*(torch.from_numpy(x) for x in (ssum, comp,
                                                             resp, w)))
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


class TestNoFallback:
    def test_kernel_on_with_cpu_tensors_raises(self):
        args, static = interop.synthetic_chunk(0, steps=512)
        t = _port_args(args)
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.cell_update(*t, block=512, kernel="on", **static)
        with pytest.raises(ValueError, match="kernel"):
            ops.cell_update(*t, block=512, kernel="interpret", **static)

    def test_prefix_counts_reject_non_prefix_masks(self):
        ok = torch.tensor([[True, False, False], [True, True, True]])
        assert torch.equal(cell_kernel.prefix_counts(ok),
                           torch.tensor([1, 3], dtype=torch.int32))
        with pytest.raises(ValueError, match="prefix"):
            cell_kernel.prefix_counts(torch.tensor([[True, False, True]]))

    def test_auto_on_cpu_is_the_plain_version(self):
        args, static = interop.synthetic_chunk(1, steps=512)
        t = _port_args(args)
        a = ops.cell_update(*t, block=512, kernel="auto", **static)
        b = ref.cell_update_ref(*t, block=512, **static)
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def test_no_except_in_kernel_dispatch_build_or_launch(self):
        kernels = Path(ops.__file__).resolve().parents[1]
        files = sorted(kernels.rglob("*.py"))
        assert len(files) >= 8
        for f in files:
            tree = ast.parse(f.read_text())
            assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), f


"""The port's RG-LRU path against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
the port: the ``rglru_scan`` kernel's plain version (a sequential loop)
against JAX's associative-scan oracle ``linear_scan_ref`` and its Pallas
kernel (interpret mode), and the whole recurrent block (prefill and
one-token decode) with the JAX block's weights carried across.

Tolerances: the scan to 2e-4 (ROADMAP queue 2 item 6; the products are
taken in another order, the worst gap measured is 4.8e-7 on values up to
6.6); the block in float32 to 2e-4 (projections, gates and the scan add
float32 roundings of their own); in bf16, the served dtype, to 0.05 (two
bf16 roundings of values of order 1 differ by up to 2^-8 each, and the
bf16 projections and output add theirs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RGLRUConfig as JaxRGLRUConfig
from repro.kernels.rglru_scan import ops as jax_scan_ops
from repro.kernels.rglru_scan import ref as jax_scan_ref
from repro.models import rglru as jax_rglru
from repro_torch import interop
from repro_torch.configs.base import RGLRUConfig
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import linear_scan_ref
from repro_torch.models import rglru

SCAN_TOL = 2e-4
BLOCK_TOL = 2e-4
BF16_TOL = 0.05


def scan_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(
        np.float32)
    return a, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 64, 32), (1, 128, 256), (3, 96, 24)])
def test_scan_plain_matches_jax(shape):
    a, b = scan_inputs(shape, shape[2])
    h = scan_ops.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert h.dtype == torch.float32 and tuple(h.shape) == shape
    for want in (jax_scan_ref.linear_scan_ref(jnp.asarray(a), jnp.asarray(b)),
                 jax_scan_ops.chunked_linear_scan(jnp.asarray(a),
                                                  jnp.asarray(b),
                                                  interpret=True)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)


def test_scan_is_separately_rounded_multiply_add():
    """Each step is ``a * h`` rounded, then ``+ b`` rounded: the arithmetic
    the CUDA kernel reproduces with __fmul_rn / __fadd_rn."""
    a, b = scan_inputs((2, 40, 8), 1)
    h = linear_scan_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.zeros((2, 8), np.float32)
    for t in range(40):
        want = (a[:, t] * want).astype(np.float32) + b[:, t]
        np.testing.assert_array_equal(h[:, t], want)


def test_scan_with_h0_matches_jax():
    a, b = scan_inputs((2, 33, 16), 2)
    h0 = np.random.default_rng(3).standard_normal((2, 16)).astype(np.float32)
    want = jax_rglru.linear_scan(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(h0))
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


def carried_block(tree, module):
    """Load a JAX block's parameter tree into the port's module."""
    state = {k: interop.to_tensor(v, "cpu") for k, v in interop._flat(tree)}
    module.load_state_dict(state, strict=True, assign=True)
    return module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_and_decode_match_jax(dtype):
    """A 20-token prefill and 3 one-token steps from its cache, with the
    JAX block's weights (nonzero biases, a spread of ``lam``)."""
    d, w = 32, 64
    jcfg = JaxRGLRUConfig(lru_width=w, conv_width=4)
    cfg = RGLRUConfig(lru_width=w, conv_width=4)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    tree = jax.device_get(jax_rglru.init_rglru_block(jax.random.PRNGKey(1), d,
                                                     jcfg, dtype=jdt))
    rng = np.random.default_rng(4)
    for key in ("conv_b", "ba", "bx"):
        tree[key] = np.asarray(jnp.asarray(
            0.3 * rng.standard_normal(tree[key].shape), jdt))
    tree["lam"] = rng.uniform(0.5, 3.0, w).astype(np.float32)
    module = carried_block(tree, rglru.init_rglru_block(
        torch.Generator("cpu").manual_seed(0), d, cfg, dtype=tdt))
    x = rng.standard_normal((2, 23, d)).astype(np.float32)
    tol = BLOCK_TOL if dtype == "float32" else BF16_TOL

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)

    out_j, cache_j = jax_rglru.rglru_block(tree, jnp.asarray(x[:, :20], jdt),
                                           jcfg, return_state=True)
    out, cache = rglru.rglru_block(module, torch.from_numpy(x[:, :20]).to(tdt),
                                   cfg, return_state=True)
    assert out.dtype == tdt and cache["h"].dtype == torch.float32
    close(out, out_j)
    close(cache["h"], cache_j["h"])
    close(cache["conv"], cache_j["conv"])
    for t in range(20, 23):
        xt = x[:, t:t + 1]
        out_j, cache_j = jax_rglru.rglru_decode(tree, jnp.asarray(xt, jdt),
                                                cache_j, jcfg)
        out, cache = rglru.rglru_decode(module, torch.from_numpy(xt).to(tdt),
                                        cache, cfg)
        close(out, out_j)
        close(cache["h"], cache_j["h"])


def test_rglru_cache_init_matches_jax():
    jcfg = JaxRGLRUConfig(lru_width=64, conv_width=4)
    cfg = RGLRUConfig(lru_width=64, conv_width=4)
    want = jax.device_get(jax_rglru.init_rglru_cache(3, 64, jcfg))
    got = rglru.init_rglru_cache(3, 64, cfg, "cpu")
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == leaf.shape, key
        assert got[key].dtype == interop.to_tensor(leaf, "cpu").dtype, key
        assert not bool(got[key].any()), key

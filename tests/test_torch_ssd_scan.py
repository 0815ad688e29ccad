"""The port's Mamba-2 SSD path against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
the port: the ``ssd_scan`` kernel's plain version against JAX's
``ssd_intra_chunk_ref`` and its Pallas kernel (interpret mode), the
chunked algorithm against JAX's (both impls) and its exact sequential
recurrence, ``causal_conv1d`` and the whole block (prefill and one-token
decode) with the JAX block's weights carried across.

Tolerances. Everything here is float32 but ``causal_conv1d`` (bf16): the
two packages sum the same products in another order. Intra-chunk term
and chunked algorithm: atol 1e-4, rtol 1e-5 (the worst gap measured is
2.3e-5 on values up to 82). The chunked algorithm against the sequential
recurrence: 1e-3, the JAX package's own tolerance for that pair
(``tests/test_kernels.py``). ``causal_conv1d``: bit for bit (both round
each bf16 product and sum the same way). The block in float32: 2e-4
(projections and norms add float32 roundings of their own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.kernels.ssd_scan import ops as jax_ssd_ops
from repro.kernels.ssd_scan import ref as jax_ssd_ref
from repro.models import rglru as jax_rglru
from repro.models import ssd as jax_ssd
from repro_torch import interop
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import rglru, ssd

ATOL, RTOL = 1e-4, 1e-5
SEQ_TOL = 1e-3
BLOCK_TOL = 2e-4


def softplus(x):
    return np.log1p(np.exp(x))


def ssd_inputs(rng, b, length, h, p, n):
    """x, B, C standard normal; dt a softplus; A = -exp(0.2 z) per head."""
    f32 = np.float32
    xh = rng.standard_normal((b, length, h, p)).astype(f32)
    bb = rng.standard_normal((b, length, n)).astype(f32)
    cc = rng.standard_normal((b, length, n)).astype(f32)
    dt = softplus(rng.standard_normal((b, length, h))).astype(f32)
    a = (-np.exp(rng.standard_normal(h) * 0.2)).astype(f32)
    return xh, bb, cc, dt, a


def close(got: torch.Tensor, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape", [
    # (B, L, H, P, N, chunk): the shapes of tests/test_kernels.py
    (2, 64, 4, 32, 16, 16),
    (1, 128, 2, 64, 32, 32),
    (2, 96, 4, 16, 8, 8),
])
def test_intra_chunk_plain_matches_jax(shape):
    b, length, h, p, n, q = shape
    nc = length // q
    xh, bb, cc, dt, a = ssd_inputs(np.random.default_rng(sum(shape)), b,
                                   length, h, p, n)
    args = (xh.reshape(b, nc, q, h, p), bb.reshape(b, nc, q, n),
            cc.reshape(b, nc, q, n), dt.reshape(b, nc, q, h))
    cum = np.cumsum(args[3] * a, axis=2).astype(np.float32)
    args = (*args, cum)
    jargs = [jnp.asarray(x) for x in args]
    y, states = ssd_ops.ssd_intra_chunk(*map(torch.from_numpy, args))
    assert y.shape == (b, nc, q, h, p) and states.shape == (b, nc, h, p, n)
    for want in (jax_ssd_ref.ssd_intra_chunk_ref(*jargs),
                 jax_ssd_ops.ssd_intra_chunk(*jargs, interpret=True)):
        close(y, want[0])
        close(states, want[1])


def test_intra_chunk_masks_by_select():
    """Above the diagonal exp(cum_q - cum_s) overflows; the plain version
    selects it away, so a steep decay still gives finite outputs."""
    rng = np.random.default_rng(0)
    b, nc, q, h, p, n = 1, 1, 64, 2, 8, 4
    dt = np.full((b, nc, q, h), 50.0, np.float32)
    cum = np.cumsum(-dt, axis=2).astype(np.float32)  # exp(+3150) = inf
    args = [torch.from_numpy(x) for x in (
        rng.standard_normal((b, nc, q, h, p)).astype(np.float32),
        rng.standard_normal((b, nc, q, n)).astype(np.float32),
        rng.standard_normal((b, nc, q, n)).astype(np.float32), dt, cum)]
    y, states = ssd_ops.ssd_intra_chunk(*args)
    assert bool(torch.isfinite(y).all() & torch.isfinite(states).all())


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_matches_jax(impl, with_h0):
    """61 steps in chunks of 16: the last chunk is padded (dt = 0)."""
    b, length, h, p, n, chunk = 2, 61, 3, 16, 8, 16
    rng = np.random.default_rng(5)
    args = ssd_inputs(rng, b, length, h, p, n)
    h0 = (rng.standard_normal((b, h, p, n)).astype(np.float32)
          if with_h0 else None)
    y_j, h_j = jax_ssd.ssd_chunked(
        *map(jnp.asarray, args), chunk,
        h0=None if h0 is None else jnp.asarray(h0), impl=impl)
    y, h_final = ssd.ssd_chunked(
        *map(torch.from_numpy, args), chunk,
        h0=None if h0 is None else torch.from_numpy(h0))
    assert y.shape == (b, length, h, p)
    close(y, y_j)
    close(h_final, h_j)
    y_s, h_s = jax_ssd.ssd_reference(
        *map(jnp.asarray, args), h0=None if h0 is None else jnp.asarray(h0))
    close(y, y_s, atol=SEQ_TOL, rtol=SEQ_TOL)
    close(h_final, h_s, atol=SEQ_TOL, rtol=SEQ_TOL)
    y_p, h_p = ssd.ssd_reference(
        *map(torch.from_numpy, args),
        h0=None if h0 is None else torch.from_numpy(h0))
    close(y_p, y_s)
    close(h_p, h_s)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_bit_for_bit(with_state):
    rng = np.random.default_rng(int(with_state))
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.5).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    state = (rng.standard_normal((2, 3, 24)).astype(np.float32)
             if with_state else None)

    def jbf(v):
        return None if v is None else jnp.asarray(v, jnp.bfloat16)

    def tbf(v):
        return None if v is None else torch.from_numpy(v).bfloat16()

    y_j, s_j = jax_rglru.causal_conv1d(jbf(w), jbf(bias), jbf(x), jbf(state))
    y, s = rglru.causal_conv1d(tbf(w), tbf(bias), tbf(x), tbf(state))
    assert y.dtype == s.dtype == torch.bfloat16 and s.shape == (2, 3, 24)
    for got, want in ((y, y_j), (s, s_j)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def carried_block(tree, module):
    """Load a JAX block's parameter tree into the port's module."""
    state = {k: interop.to_tensor(v, "cpu") for k, v in interop._flat(tree)}
    module.load_state_dict(state, strict=True, assign=True)
    return module


def test_ssd_block_and_decode_match_jax():
    """The block in float32 with the JAX block's weights: a 21-token
    prefill (chunks of 8, the last padded) and 3 one-token steps from its
    cache."""
    d = 32
    jcfg = JaxSSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16, chunk=8)
    cfg = SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16, chunk=8)
    tree = jax.device_get(jax_ssd.init_ssd_block(
        jax.random.PRNGKey(0), d, jcfg, dtype=jnp.float32))
    # nonzero biases and norm scale, so every parameter matters
    rng = np.random.default_rng(2)
    for key in ("conv_x_b", "conv_bc_b", "dt_bias", "a_log"):
        tree[key] = (0.3 * rng.standard_normal(tree[key].shape)).astype(
            np.float32)
    tree["norm"]["scale"] = (0.1 * rng.standard_normal(
        tree["norm"]["scale"].shape)).astype(np.float32)
    module = carried_block(tree, ssd.init_ssd_block(
        torch.Generator("cpu").manual_seed(0), d, cfg, dtype=torch.float32))
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    out_j, cache_j = jax_ssd.ssd_block(tree, jnp.asarray(x[:, :21]), jcfg,
                                       return_state=True)
    out, cache = ssd.ssd_block(module, torch.from_numpy(x[:, :21]), cfg,
                               return_state=True)
    close(out, out_j, atol=BLOCK_TOL, rtol=BLOCK_TOL)
    close(cache["h"], cache_j["h"], atol=BLOCK_TOL, rtol=BLOCK_TOL)
    for key in ("x", "bc"):
        close(cache["conv"][key], cache_j["conv"][key], atol=BLOCK_TOL,
              rtol=BLOCK_TOL)
    for t in range(21, 24):
        out_j, cache_j = jax_ssd.ssd_decode(tree, jnp.asarray(x[:, t:t + 1]),
                                            cache_j, jcfg)
        out, cache = ssd.ssd_decode(module, torch.from_numpy(x[:, t:t + 1]),
                                    cache, cfg)
        close(out, out_j, atol=BLOCK_TOL, rtol=BLOCK_TOL)
        close(cache["h"], cache_j["h"], atol=BLOCK_TOL, rtol=BLOCK_TOL)


def test_ssd_cache_init_matches_jax():
    jcfg = JaxSSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=8)
    cfg = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=8)
    want = jax.device_get(jax_ssd.init_ssd_cache(3, 64, jcfg))
    got = ssd.init_ssd_cache(3, 64, cfg, "cpu")
    assert set(got) == {"conv", "h"} and set(got["conv"]) == {"x", "bc"}
    for path, leaf in interop._flat(want):
        mine = dict(interop._flat(got))[path]
        assert tuple(mine.shape) == leaf.shape, path
        assert mine.dtype == interop.to_tensor(leaf, "cpu").dtype, path
        assert not bool(mine.any()), path
